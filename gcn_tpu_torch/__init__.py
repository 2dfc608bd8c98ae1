"""gcn_tpu_torch — the PyTorch / CUDA port of gcn_tpu for NVIDIA Hopper.

A package beside ``gcn_tpu`` (the JAX reference, which it never imports):
GCN training over the v1–v6 ladder, with the packed-ELL SpMM as the
hand-written CUDA kernel K1 (``ops/csrc/ell_spmm.cu``). Entry points run on
the card unless the caller passes ``device="cpu"``; kernels build at first
use into ``gcn_tpu_torch/_build/``.
"""

__version__ = "0.1.0"
