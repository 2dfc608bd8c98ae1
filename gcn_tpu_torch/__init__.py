"""gcn_tpu_torch — the PyTorch / CUDA port of gcn_tpu for NVIDIA Hopper.

A package beside ``gcn_tpu`` (the JAX reference, which it never imports):
GCN training over the v1–v6 ladder, with the packed-ELL SpMM as the
hand-written CUDA kernel K1 (``ops/csrc/ell_spmm.cu``), also over the
frequency-split tables (``tile/freq_split.py``); functional GCN training
over the panel layout (``tile.panel_adjacency``) with the panel SpMM as
kernel K2 (``ops/csrc/panel_spmm.cu``); HGNN (``models.HGNN``) over the
hypergraph operator G or its two factors (``ops.spmm.TwoHopAdj``), on K1;
row-band sharded GCN training (``parallel``: the ragged halo exchange over
``torch.distributed`` and the pass-block sharded ELL layout, on K1); and
resumable training state in gcn_tpu's checkpoint format. The entry points
(``models.GCN``, ``models.HGNN``, ``train_gcn``, ``train_hgnn``,
``train_gcn_dist``, the layout functions, ``parallel.create_mesh``) run on
the card unless the caller passes
``device="cpu"``; kernels build at first use into
``gcn_tpu_torch/_build/``.
"""

__version__ = "0.1.0"
