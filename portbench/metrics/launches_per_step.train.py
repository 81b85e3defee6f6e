"""launches_per_step.train: device kernels in the traced window per step."""


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    return len(r.trace.kernels) / r.trace.units
