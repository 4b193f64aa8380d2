"""PyTorch + CUDA port of ``pdunet_tpu`` for NVIDIA Hopper (H100).

Module names mirror the JAX package so each piece has an obvious
counterpart. The port imports ``torch`` and numpy only: nothing of JAX and
nothing of ``pdunet_tpu`` (the numpy-only modules it needs are copied).

Entry points take an explicit ``device=`` that defaults to ``"cuda"``; the
CPU is used only when a caller asks for it. The projector's hand-written
CUDA kernels (``ops/radon/csrc/``) run for CUDA tensors, and their plain
PyTorch versions for CPU tensors.
"""
