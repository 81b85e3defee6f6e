"""optimizer_host_ms.train: the host's time per train step in PyTorch's span
``Optimizer.step#Ranger.step``, less its clip's sync span, on the main
thread of the traced pass with host ranges, in ms: Ranger in the step's own
flow (``optimizer_ms.train`` times it alone, the card drained around it)."""

from portbench.spans import OPTIMIZER, STEP, of


def read(r):
    sp = of(r, "train")
    if sp is None or sp.count(STEP) == 0 or sp.count(OPTIMIZER) == 0:
        return None
    return 1e3 * sp.self_s(OPTIMIZER) / sp.count(STEP)
