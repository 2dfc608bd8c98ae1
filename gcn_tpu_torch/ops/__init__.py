"""Sparse operators: device adjacencies, the spmm dispatch and kernel K1.

Kept free of imports so that ``gcn_tpu_torch.ops._build`` loads alone."""
