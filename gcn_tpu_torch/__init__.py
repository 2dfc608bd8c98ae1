"""gcn_tpu_torch — the PyTorch / CUDA port of gcn_tpu for NVIDIA Hopper.

A package beside ``gcn_tpu`` (the JAX reference, which it never imports):
GCN training over the v1–v6 ladder, with the packed-ELL SpMM as the
hand-written CUDA kernel K1 (``ops/csrc/ell_spmm.cu``), also over the
frequency-split tables (``tile/freq_split.py``); functional GCN training
over the panel layout (``tile.panel_adjacency``) with the panel SpMM as
kernel K2 (``ops/csrc/panel_spmm.cu``); HGNN (``models.HGNN``) over the
hypergraph operator G or its two factors (``ops.spmm.TwoHopAdj``), on K1;
row-band sharded GCN training (``parallel``: the halo exchanges over
``torch.distributed`` and the sharded ELL layouts, on K1), with the
weak-scaling projection on the card's own rates (``parallel.projection``);
and resumable training state in gcn_tpu's checkpoint format. The entry points
(``models.GCN``, ``models.HGNN``, ``train_gcn``, ``train_hgnn``,
``train_gcn_dist``, the layout functions, ``parallel.create_mesh``) run on
the card unless the caller passes
``device="cpu"``; kernels build at first use into
``gcn_tpu_torch/_build/``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level conveniences, as gcn_tpu's: ``import gcn_tpu_torch``
    # loads no model, kernel or CUDA extension
    if name == "GCN":
        from gcn_tpu_torch.models import GCN
        return GCN
    if name == "HGNN":
        from gcn_tpu_torch.models import HGNN
        return HGNN
    if name == "get_dataset":
        from gcn_tpu_torch.data import get_dataset
        return get_dataset
    if name == "spmm":
        from gcn_tpu_torch.ops.spmm import spmm
        return spmm
    raise AttributeError(f"module 'gcn_tpu_torch' has no attribute {name!r}")


__all__ = ["__version__", "GCN", "HGNN", "get_dataset", "spmm"]
