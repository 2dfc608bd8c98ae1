"""The port's ELL SpMM against gcn_tpu's, on the same inputs made with numpy.

On the CPU ``spmm_ell`` takes K1's plain version; it is held against
``gcn_tpu.ops.ell_spmm.spmm_ell`` (its Pallas reduce in interpret mode),
forward and dX, at rtol/atol 1e-5, over the branches of gcn_tpu's
``_spmm_ell_impl`` (the rest are in test_torch_port_spmm_branches.py).
The kernel itself is held against the plain version on the card in
test_torch_port_cuda.py.
"""

import pytest

from torch_port_graphs import check_case


@pytest.mark.parametrize("case", ["grouped_spans", "hub_split",
                                  "merged_hub_region", "small_span_limit",
                                  "row_chunked", "unsorted_guarded"])
def test_spmm_ell_matches_gcn_tpu(case):
    check_case(case)
