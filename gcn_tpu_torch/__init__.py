"""gcn_tpu_torch — the PyTorch / CUDA port of gcn_tpu for NVIDIA Hopper.

A package beside ``gcn_tpu`` (the JAX reference, which it never imports):
GCN training over the v1–v6 ladder, with the packed-ELL SpMM as the
hand-written CUDA kernel K1 (``ops/csrc/ell_spmm.cu``), and functional GCN
training over the panel layout (``tile.panel_adjacency``) with the panel
SpMM as kernel K2 (``ops/csrc/panel_spmm.cu``). The entry points
(``models.GCN``, ``train_gcn``, ``tile.panel_adjacency``) run on the card
unless the caller passes ``device="cpu"``; kernels build at first use into
``gcn_tpu_torch/_build/``.
"""

__version__ = "0.1.0"
