"""Entry (``pipeline.extract_features``): wall milliseconds of a call's
host work before its first batch, the configuration, the manager's and
the batch plan's header scans and the executor's set-up (counter
``plan_s``), per call (counter ``calls``)."""


def read(run):
    calls = run.counters.get('calls', 0)
    if 'plan_s' not in run.counters or not calls:
        return None
    return 1e3 * run.counters['plan_s'] / calls
