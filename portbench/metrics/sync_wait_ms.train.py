"""sync_wait_ms.train: the summed length per train step of the
``hspose.sync.*`` spans on the main thread, in the traced pass with host
ranges, in ms: the host blocked on the card."""

from portbench.spans import STEP, per_unit


def read(r):
    v = per_unit(r, "train", STEP, lambda sp: sp.sync_s())
    return None if v is None else 1e3 * v
