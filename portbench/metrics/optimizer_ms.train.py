"""optimizer_ms.train: Ranger's ``step()`` per step, on the host clock over
``trace_units`` steps of a traced run, the device drained before and after
each call: the optimizer's host work and kernels alone, with no wait for
the backward in it."""


def read(r):
    if r.kind != "train" or "optimizer_s_per_step" not in r.host:
        return None
    return 1e3 * r.host["optimizer_s_per_step"]
