"""device_idle.train: the share of the traced window in which no operation ran
on the card, 1 - union of the device intervals / window, in %."""


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    t = r.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
