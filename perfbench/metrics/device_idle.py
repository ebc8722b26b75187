"""Device: the share of the traced window in which no operation ran on
the card (1 - the union of the device operations' intervals over the
window's wall), in percent."""


def read(run):
    window = run.window_us
    busy = run.busy_us()
    if not window or not busy:
        return None
    return 100.0 * (1.0 - busy / window)
