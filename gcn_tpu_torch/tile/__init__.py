from gcn_tpu_torch.tile.ell import EllAdj, degree_sort_order, ell_adjacency

__all__ = ["EllAdj", "degree_sort_order", "ell_adjacency"]
