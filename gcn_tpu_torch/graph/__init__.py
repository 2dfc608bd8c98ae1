from gcn_tpu_torch.graph.csr import CSRGraph, coo_to_csr
from gcn_tpu_torch.graph.normalize import (gcn_normalize, row_normalize,
                                           row_normalize_features)

__all__ = ["CSRGraph", "coo_to_csr", "gcn_normalize", "row_normalize",
           "row_normalize_features"]
