"""95th percentile of the request latency over all requests of the window,
in ms (host clock from the call to the volume in pinned host memory)."""

import statistics


def read(run):
    lat = run.latencies
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
