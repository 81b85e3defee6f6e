"""request_ms_p95: the 95th percentile over every request of the window of
the time from its call of ``batched_pose_inference`` to the return of its
poses on the host, in ms."""

import statistics


def read(r):
    lat = r.window.get("latencies_s")
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles([x * 1e3 for x in lat], n=100, method="inclusive")[94]
