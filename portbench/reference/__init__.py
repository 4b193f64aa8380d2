"""The benchmark's plain reference: the operators, the Primal-Dual UNet and
the training step, written again in plain PyTorch from the configuration.

Nothing here imports the program under test (``pdunet_tpu_torch``) or JAX.
Every quantity the program derives (plans, tables, the operator norm, the
density compensation, the optimizer state) is worked out again here. The
reference computes in float32 with TF32 off; :class:`Precision` lowers it
for the control (``precision.CONTROL``).
"""
