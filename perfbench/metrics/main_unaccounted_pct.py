"""Entry (``pipeline.extract_features``): the share of the calls' wall on
their own thread (counter ``call_s``) that none of its disjoint counted
intervals covers: planning, waiting for decoded audio, enqueuing,
waiting for outputs, handing them out and waiting for pass 2, in
percent."""

PARTS = ('plan_s', 'decode_wait_s', 'dispatch_s', 'fetch_s', 'drain_s',
         'pass2_join_s')


def read(run):
    counts = run.counters
    if not counts.get('call_s') or any(key not in counts for key in PARTS):
        return None
    return 100.0 * (1.0 - sum(counts[key] for key in PARTS)
                    / counts['call_s'])
