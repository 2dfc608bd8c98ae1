"""The work a step needs, counted from the configuration's shapes: the
yardstick of the rooflines and of the step's share of the chip's peak.

Counts depend on sizes only (rows, stored edges, widths), never on how the
program lays the matrices out, so any implementation is held to the same
work. Peaks are the NVIDIA H100 SXM data sheet's: 3.35 TB/s of HBM and 67
TFLOP/s of float32 outside the tensor cores (the configurations compute in
float32 with TF32 off).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def csr_spmm_work(nnz: int, n_rows: int, n_in: int, k: int):
    """(bytes, flops) of ``out = A @ x`` over a CSR matrix of ``nnz``
    stored entries and ``n_rows`` rows, x of ``n_in`` rows and width
    ``k``: each entry's column and value (8 B), the row pointers, x read
    once and out written once (f32); 2 flops an entry and column."""
    return (8 * nnz + 4 * (n_rows + 1) + 4 * n_in * k + 4 * n_rows * k,
            2 * nnz * k)


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the H100 needs for the work: the larger of the bytes
    over the HBM rate and the flops over the f32 peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def two_layer_iteration_flops(n: int, f: int, h: int, c: int,
                              nnz: int) -> int:
    """Matrix-product flops of one training iteration of a two-layer model
    ``S (relu(S X W1 + b1) W2) + b2`` whose layer-1 aggregation ``S X`` is
    hoisted out of the loop (GCN with S = A-hat, HGNN with S = G), as the
    job runs it: the training forward, the backward (no gradient for the
    constant S X), and the evaluation forward each iteration runs.

      forward:  (S X) W1  2nfh,  h W2  2nhc,  S (h W2)  2 nnz c
      backward: dW2 and dh  4nhc,  S^T g  2 nnz c,  dW1  2nfh
      eval:     the forward again

    Element-wise work (bias, relu, dropout, softmax, the optimizer) is left
    out: it is not a matrix product and is small beside them.
    """
    return 6 * n * f * h + 8 * n * h * c + 6 * nnz * c
