from gcn_tpu_torch.tile.ell import EllAdj, degree_sort_order, ell_adjacency
from gcn_tpu_torch.tile.format import PanelAdj
from gcn_tpu_torch.tile.freq_split import (FreqSplitAdj, ell_adjacency_freq,
                                           spmm_ell_freq)
from gcn_tpu_torch.tile.tiler import panel_adjacency

__all__ = ["EllAdj", "FreqSplitAdj", "PanelAdj", "degree_sort_order",
           "ell_adjacency", "ell_adjacency_freq", "panel_adjacency",
           "spmm_ell_freq"]
