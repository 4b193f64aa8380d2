"""Host seconds of set-up's ``setup.plans`` spans (each operator's
construction in ``build_task``: plans, tables, radial DCF), less the
library loads inside them, in a run that records the program's spans
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.setup_s(run, "setup.plans", less="setup.kernels")
