"""hs_roofline.train: the least time of the port's kernel work in the traced
window (the searches and HS reductions, ``counts.py::kernel_ops``, from the
cell's shapes) over the device time of the port's kernels there (every
kernel that is neither PyTorch's nor a library's, ``trace.py``), in %."""


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    spent = r.trace.kernel_s(port_only=True)
    if spent <= 0:
        return None
    return 100.0 * r.trace.units * r.kernel_least_s_per_unit() / spent
