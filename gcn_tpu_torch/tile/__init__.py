from gcn_tpu_torch.tile.ell import EllAdj, degree_sort_order, ell_adjacency
from gcn_tpu_torch.tile.format import PanelAdj
from gcn_tpu_torch.tile.tiler import panel_adjacency

__all__ = ["EllAdj", "PanelAdj", "degree_sort_order", "ell_adjacency",
           "panel_adjacency"]
