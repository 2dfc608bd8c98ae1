"""The port's ELL SpMM against gcn_tpu's on the remaining branches of
``_spmm_ell_impl``: non-square and non-symmetric matrices, k below and above
k_pad, and the k_pad=128 pass ladder (forward and dX, rtol/atol 1e-5)."""

import pytest

from torch_port_graphs import check_case


@pytest.mark.parametrize("case", ["rectangular", "rect_hub_split",
                                  "k_below_k_pad", "k_above_k_pad",
                                  "k_128_k_pad_32", "k_pad_128_ladder"])
def test_spmm_ell_matches_gcn_tpu(case):
    check_case(case)
