"""Pipeline pass 2: wall milliseconds the call waited for the thread
``pass-two`` after pass 1 (counter ``pass2_join_s``, span
``pass2.join``), per call (counter ``calls``)."""


def read(run):
    calls = run.counters.get('calls', 0)
    if 'pass2_join_s' not in run.counters or not calls:
        return None
    return 1e3 * run.counters['pass2_join_s'] / calls
