"""launches_per_batch.serve: device kernels in the traced window per batch
of the model (a request is crops_per_request / batch batches)."""


def read(r):
    if r.kind != "serve" or r.trace is None:
        return None
    return len(r.trace.kernels) / (r.trace.units * r.per_unit_batches())
