"""Host seconds of set-up's ``setup.kernels`` spans (each kernel library's
nvcc build and load), in a run that records the program's spans
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.setup_s(run, "setup.kernels")
