"""forward_host_ms.serve: the host's time per served batch in the span
``hspose.harness.forward`` (``eval_forward`` + ``generate_RT`` enqueued),
less any sync span in it, on the main thread of the traced pass with host
ranges, in ms: the host's cost to enqueue the model, which paces serving
once it reaches the card's time per batch."""

from portbench.spans import BATCH, per_unit


def read(r):
    v = per_unit(r, "serve", BATCH, lambda sp: sp.self_s(BATCH))
    return None if v is None else 1e3 * v
