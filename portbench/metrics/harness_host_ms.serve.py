"""harness_host_ms.serve: the host's own time per served batch in the
harness's spans ``hspose.harness.ingest``, ``to_device`` and ``land``, less
the sync spans nested in them (the uploads' and fetches' waits for the
card), on the main thread of the traced pass with host ranges, in ms."""

from portbench.spans import BATCH, per_unit

PARTS = ("hspose.harness.ingest", "hspose.harness.to_device", "hspose.harness.land")


def read(r):
    v = per_unit(r, "serve", BATCH, lambda sp: sp.self_s(*PARTS))
    return None if v is None else 1e3 * v
