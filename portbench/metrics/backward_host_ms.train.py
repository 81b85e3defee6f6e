"""backward_host_ms.train: the time per train step in the span
``hspose.train.backward`` (``total.backward()`` on the calling thread, which
waits there for autograd's own threads), less any sync span in it, in the
traced pass with host ranges, in ms."""

from portbench.spans import STEP, per_unit


def read(r):
    v = per_unit(r, "train", STEP, lambda sp: sp.self_s("hspose.train.backward"))
    return None if v is None else 1e3 * v
