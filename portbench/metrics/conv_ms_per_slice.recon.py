"""Device ms of the convolution kernels (cuDNN forward, data- and
weight-gradient kernels; not the layout conversions around them) per
reconstructed slice in the traced slice."""

import re

CONV = re.compile(r"fprop|dgrad|wgrad|conv|implicit_gemm|implicit_convolve", re.I)
LAYOUT = re.compile(r"nchwToNhwc|nhwcToNchw", re.I)


def read(run):
    if run.trace is None or not run.trace_units:
        return None
    seconds, n = run.trace.device_seconds(lambda s: bool(CONV.search(s)) and not LAYOUT.search(s))
    if n == 0:
        return None
    return seconds * 1e3 / run.trace_units
