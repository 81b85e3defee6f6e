"""forward_host_ms.train: the host's time per train step in the span
``hspose.train.forward`` (augmentation, posenet, losses enqueued), less any
sync span in it, on the main thread of the traced pass with host ranges,
in ms."""

from portbench.spans import STEP, per_unit


def read(r):
    v = per_unit(r, "train", STEP, lambda sp: sp.self_s(STEP))
    return None if v is None else 1e3 * v
