"""host_syncs_per_step.train: ``hspose.sync.*`` spans on the main thread per
train step (each a read that makes the host wait for the card: the NaN
guard, the clip, the metrics' fetches), in the traced pass with host
ranges."""

from portbench.spans import STEP, per_unit


def read(r):
    return per_unit(r, "train", STEP, lambda sp: sp.sync_count())
