"""Row permutation of dense feature and label tensors.

The port of ``gcn_tpu.ops.permute``: one gather on the tensor's device
(autograd's backward is the scatter of the inverse), with labels moved by
the same op as features.
"""

from __future__ import annotations

import numpy as np
import torch


def permute_rows(x: torch.Tensor, perm_new_to_old) -> torch.Tensor:
    """out[new] = x[perm[new]], differentiable."""
    perm = torch.as_tensor(np.asarray(perm_new_to_old), dtype=torch.int64,
                           device=x.device)
    return x.index_select(0, perm)


def inverse_permutation(perm_new_to_old) -> np.ndarray:
    """inv[old] = new, so ``permute_rows(y, inv)`` undoes ``permute_rows``."""
    perm = np.asarray(perm_new_to_old)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def remap_indices(idx, perm_new_to_old) -> torch.Tensor:
    """Old-order vertex indices -> new-order (int64)."""
    inv = inverse_permutation(perm_new_to_old)
    return torch.as_tensor(inv[np.asarray(idx)], dtype=torch.int64)
