"""CREPE CNN: the share of the frames the CNN ran (counter
``crepe_cnn_frames``) whose six conv blocks ran in the hand-written
conv kernel (counter ``crepe_conv_kernel_frames``), in percent."""


def read(run):
    ran = run.counters.get('crepe_cnn_frames', 0)
    if 'crepe_conv_kernel_frames' not in run.counters or not ran:
        return None
    return 100.0 * run.counters['crepe_conv_kernel_frames'] / ran
