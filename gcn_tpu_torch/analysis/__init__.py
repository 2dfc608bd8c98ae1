from gcn_tpu_torch.analysis.rows import nnz_per_row, plot_row_cdfs, row_cdf

__all__ = ["nnz_per_row", "row_cdf", "plot_row_cdfs"]
