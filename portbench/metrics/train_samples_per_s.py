"""train_samples_per_s: steps x B over the window's wall time, which ends in
``torch.cuda.synchronize()`` (host clock)."""


def read(r):
    if "samples" not in r.window:
        return None
    return r.window["samples"] / r.window["elapsed_s"]
