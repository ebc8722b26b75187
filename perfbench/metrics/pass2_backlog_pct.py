"""Pipeline pass 2: the share of the utterances pass 2 finished
(counter ``pass2_utts``) that were still waiting for it or in it when
pass 1 ended (counter ``pass2_backlog_utts``), in percent: near 100,
the groups completed too late to overlap pass 1."""


def read(run):
    finished = run.counters.get('pass2_utts', 0)
    if 'pass2_backlog_utts' not in run.counters or not finished:
        return None
    return 100.0 * run.counters['pass2_backlog_utts'] / finished
