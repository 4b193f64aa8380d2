"""Host seconds of set-up's ``setup.opnorm`` span (σ's power iteration in
``build_task``), less the library loads inside it, in a run that records
the program's spans (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.setup_s(run, "setup.opnorm", less="setup.kernels")
