"""Sparse x dense matmul with gradients.

Counterpart of ``languagegroundedsemseg_tpu/ops/sparse_mm.py``, the
replacement for the reference's SparseMM autograd wrapper
(lib/math_functions.py:5-27):
- ``sparse_mm_coo``: a COO matrix (``torch.sparse_coo_tensor``) @ dense, the
  counterpart of ``sparse_mm_bcoo``;
- ``sparse_mm_padded``: a gather / segment-sum over padded triplets
  (entries with row < 0 dropped), the fixed-capacity form.
Both are differentiable with respect to the values and the dense matrix.
"""

from __future__ import annotations

import torch


def sparse_mm_coo(data, indices, shape, dense) -> torch.Tensor:
    """(values (nnz,), indices (nnz, 2), shape (2,)) @ dense (K, F);
    repeated indices add."""
    m = torch.sparse_coo_tensor(indices.t().long(), data, tuple(int(s) for s in shape),
                                check_invariants=True)
    return torch.sparse.mm(m, dense)


def sparse_mm_padded(rows, cols, vals, num_rows: int, dense) -> torch.Tensor:
    """out[r] += vals[i] * dense[cols[i]] for each triplet with rows[i] >= 0
    (cols of dropped triplets may be -1)."""
    keep = rows >= 0
    contrib = vals[:, None] * dense[torch.clamp(cols, min=0).long()]
    contrib = torch.where(keep[:, None], contrib,
                          torch.zeros((), dtype=contrib.dtype, device=contrib.device))
    seg = torch.where(keep, rows, torch.full_like(rows, num_rows)).long()
    out = contrib.new_zeros((num_rows + 1, dense.shape[1]))
    return out.index_add(0, seg, contrib)[:num_rows]
