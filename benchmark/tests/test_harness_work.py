"""work.py's counts against values worked out by hand."""

from benchmark import work


def test_csr_spmm_work_gcn_arxiv():
    # A-hat: 2,315,598 stored edges + 169,343 self loops; k = 40
    nnz, n, k = 2_484_941, 169_343, 40
    b, f = work.csr_spmm_work(nnz, n, n, k)
    # 8 B x 2,484,941 + 4 B x 169,344 + 2 x (4 B x 169,343 x 40)
    assert b == 19_879_528 + 677_376 + 54_189_760
    assert f == 198_795_280
    # bytes bound it: 74,746,664 B / 3.35e12 B/s
    assert abs(work.bound_s(b, f) - 74_746_664 / 3.35e12) < 1e-18


def test_csr_spmm_work_hgnn_g():
    b, f = work.csr_spmm_work(644_713, 12_311, 12_311, 40)
    assert b == 5_157_704 + 49_248 + 3_939_520
    assert f == 51_577_040


def test_iteration_flops_gcn_arxiv():
    # 6nfh = 6 x 169,343 x 128 x 256; 8nhc = 8 x 169,343 x 256 x 40;
    # 6 nnz c = 6 x 2,484,941 x 40
    flops = work.two_layer_iteration_flops(169_343, 128, 256, 40,
                                           2_484_941)
    assert flops == 33_294_188_544 + 13_872_578_560 + 596_385_840
    # ~47.76 GFLOP: at 2.8 ms an iteration, 25.5% of 67 TFLOP/s
    assert abs(100 * flops / (2.8e-3 * 67e12) - 25.460) < 1e-3


def test_iteration_flops_hgnn_modelnet40():
    # 6 x 12,311 x 2,048 x 128 + 8 x 12,311 x 128 x 40 + 6 x 644,713 x 40
    flops = work.two_layer_iteration_flops(12_311, 2_048, 128, 40, 644_713)
    assert flops == 19_363_528_704 + 504_258_560 + 154_731_120
