"""idle_in_harness.serve: the share of the traced window (the pass with host
ranges) in which no device interval runs while the main thread is inside
``hspose.harness.ingest``, ``to_device`` or ``land`` and outside any sync
span: the card starved by the harness's own host work, in %."""

from portbench.spans import of

PARTS = ("hspose.harness.ingest", "hspose.harness.to_device", "hspose.harness.land")


def read(r):
    sp = of(r, "serve")
    if sp is None:
        return None
    return 100.0 * sp.idle_inside_s(*PARTS) / r.trace_host.window_s
