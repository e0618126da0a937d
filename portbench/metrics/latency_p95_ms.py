"""The 95th percentile (nearest rank) of every request's latency in the
window, from when it was due to the end of the ``step()`` that returned it;
a failed request counts as missing any limit."""

import math


def read(rec):
    lat = sorted(rec.get("latencies_s") or [])
    if not lat:
        return None
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    return 1e3 * p95 if math.isfinite(p95) else None
