"""graph_replays_per_step.train: the train step's CUDA graph replays
(``hspose.train.graph_replay`` spans) per train step (``hspose.train.forward``
spans) on the main thread of the traced pass with host ranges: 1 where every
step replays its graph, 0 where every step runs op by op."""

from portbench.spans import STEP, per_unit

REPLAY = "hspose.train.graph_replay"


def read(r):
    return per_unit(r, "train", STEP, lambda sp: sp.count(REPLAY))
