"""What the traffic kinds' loops share: the generator streams derived from a
run's seed, the device's synchronisation, and the profiled slice of a
traced run."""

from __future__ import annotations

import torch

from portbench.trace import SLICE, read_profile

__all__ = ["WEIGHT_STREAM", "DATA_STREAM", "POOL_STREAM", "CHECK_STREAM", "sync",
           "TracedSlice"]

#: generator streams derived from a run's seed (2 is the training loop's data stream)
WEIGHT_STREAM, POOL_STREAM, CHECK_STREAM, DATA_STREAM = 1, 4, 5, 2


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TracedSlice:
    """``torch.profiler`` over a slice of the window, inside
    ``record_function(SLICE)``, the device synchronised at both ends."""

    def __init__(self, device):
        self.device = device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self):
        sync(self.device)
        self.prof.start()
        self.span = torch.profiler.record_function(SLICE)
        self.span.__enter__()

    def stop(self):
        """The slice's :class:`portbench.trace.Trace`."""
        sync(self.device)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        return read_profile(self.prof)
