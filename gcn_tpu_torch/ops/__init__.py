"""Sparse operators: device adjacencies, the spmm dispatch, kernels K1 and K2.

Kept free of imports so that ``gcn_tpu_torch.ops._build`` loads alone."""
