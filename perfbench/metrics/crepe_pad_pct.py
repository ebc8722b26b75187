"""CREPE CNN: the share of the frames the CNN ran (counter
``crepe_cnn_frames``: the frames of each slice of
``CrepePitchProcessor.process_all`` that its convolutions ran) that are
padding, not an utterance's model frame (counter ``crepe_frames``), in
percent. Where the CNN runs on each row's real frames alone, it reads
0."""


def read(run):
    ran = run.counters.get('crepe_cnn_frames', 0)
    if 'crepe_frames' not in run.counters or not ran:
        return None
    return 100.0 * (ran - run.counters['crepe_frames']) / ran
