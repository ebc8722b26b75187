"""Pipeline pass 2: the share of the utterances pass 2 finished (counter
``pass2_utts``) whose CMVN, deltas and pitch concatenation ran in the
kernel ``csrc/pass_two.cu`` (counter ``pass2_kernel_utts``), in
percent."""


def read(run):
    finished = run.counters.get('pass2_utts', 0)
    if 'pass2_kernel_utts' not in run.counters or not finished:
        return None
    return 100.0 * run.counters['pass2_kernel_utts'] / finished
