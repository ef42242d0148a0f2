"""m:n structured-sparsity masks.

Counterpart of ``apex_tpu/contrib/sparsity/sparse_masklib.py`` (ref
apex/contrib/sparsity/sparse_masklib.py).  A mask keeps, in every group
of ``m`` consecutive weights along the pruned axis, the valid pattern
that keeps the most magnitude: the argmax over the table of valid
patterns of the kept ``|w|`` summed.  The pattern tables are the JAX
package's, row for row, since their order decides ties (``argmax``
returns the first maximum on both sides).

The scores are sums, not products: each pattern's kept values are added
in the order XLA's CPU dot adds them (``_best``), which no TF32 setting
can change.  So a mask is the same on the card, on the CPU and in the
JAX package.  The 1d and the
exhaustive 2d masks are computed on the tensor's device; the greedy 2d
variant is host numpy, as in the JAX package and the reference (an
offline operation before training).

Layouts: ``create_mask`` takes the tensor in its framework layout and
prunes along the reduction axis: ``"io"``/``"hwio"`` for flax Dense and
Conv kernels (the port keeps those layouts: ``Dense.kernel`` is
(in, out)), ``None``/``"oi"``/``"oihw"`` for torch-layout tensors.
"""
from __future__ import annotations

import collections
from functools import lru_cache
from itertools import permutations
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["compute_valid_1d_patterns", "compute_valid_2d_patterns",
           "create_mask", "m4n2_1d", "m4n2_2d_best", "m4n2_2d_greedy",
           "mn_1d_best", "mn_2d_best", "mn_2d_greedy"]


@lru_cache(maxsize=None)
def compute_valid_1d_patterns(m: int, n: int) -> np.ndarray:
    """All binary m-vectors with exactly n ones.  ref
    sparse_masklib.py:25-34."""
    base = [1.0] * n + [0.0] * (m - n)
    pats = sorted(set(permutations(base)))
    return np.asarray(pats, dtype=np.float32)


@lru_cache(maxsize=None)
def compute_valid_2d_patterns(m: int, n: int) -> np.ndarray:
    """All m x m binary blocks with every row n:m and every column <= n.

    ref sparse_masklib.py:103-119 (for 4:2 this yields 90 patterns).
    """
    rows = [tuple(p) for p in compute_valid_1d_patterns(m, n)]
    out = []
    for combo in permutations(rows * 2, m):
        block = np.asarray(combo, dtype=np.float32)
        if (block.sum(axis=0) <= n).all():
            out.append(block)
    uniq = {b.tobytes(): b for b in out}
    return np.stack(list(uniq.values()))


def _pad_cols(mat: torch.Tensor, m: int) -> torch.Tensor:
    """Zero-pad the last axis to a multiple of m.  ref
    sparse_masklib.py:13-21."""
    rem = mat.shape[-1] % m
    return F.pad(mat, (0, m - rem)) if rem else mat


def _best(groups: torch.Tensor, patterns: np.ndarray) -> torch.Tensor:
    """The index of each group's best pattern: ``groups`` (G, k) of |w|
    in fp32, ``patterns`` (P, k) of 0/1.  A score is summed as XLA's CPU
    dot sums a product with a 0/1 table: the even and the odd positions
    in two running fp32 sums, then the two added.  That gives the JAX
    package's scores on the CPU bit for bit, and the same scores on the
    card, where a product would follow the TF32 setting."""
    table = torch.as_tensor(patterns, device=groups.device)
    lanes = []
    for first in (0, 1):
        acc = torch.zeros(groups.shape[0], table.shape[0],
                          device=groups.device)
        for pos in range(first, groups.shape[1], 2):
            acc = acc + groups[:, pos, None] * table[:, pos]
        lanes.append(acc)
    return torch.argmax(lanes[0] + lanes[1], dim=1)


def mn_1d_best(matrix: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Best m:n pattern per group of m consecutive entries of the last axis.

    ref sparse_masklib.py:37-47: keep the pattern that keeps the most
    magnitude."""
    rows, cols = matrix.shape
    patterns = compute_valid_1d_patterns(m, n)
    mat = _pad_cols(matrix.float().abs(), m).reshape(-1, m)
    table = torch.as_tensor(patterns, device=matrix.device)
    return table[_best(mat, patterns)].reshape(rows, -1)[:, :cols]


def m4n2_1d(mat: torch.Tensor, density: float = 0.5) -> torch.Tensor:
    return mn_1d_best(mat, 4, 2)


def mn_2d_best(matrix: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Exhaustive best m:n mask over m x m blocks (rows AND columns m:n),
    so the transposed tensor is also m:n sparse.  ref
    sparse_masklib.py:122-138; both dims must be multiples of m."""
    rows, cols = matrix.shape
    if rows % m or cols % m:
        raise ValueError(f"mn_2d_best needs dims divisible by {m}, got "
                         f"{tuple(matrix.shape)}")
    patterns = compute_valid_2d_patterns(m, n).reshape(-1, m * m)
    blocks = (matrix.float().abs()
              .reshape(rows // m, m, cols // m, m)
              .permute(0, 2, 1, 3)
              .reshape(-1, m * m))
    table = torch.as_tensor(patterns, device=matrix.device)
    return (table[_best(blocks, patterns)]
            .reshape(rows // m, cols // m, m, m)
            .permute(0, 2, 1, 3)
            .reshape(rows, cols))


def m4n2_2d_best(mat: torch.Tensor, density: float = 0.5) -> torch.Tensor:
    return mn_2d_best(mat, 4, 2)


def mn_2d_greedy(matrix: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Greedy 2d m:n selection on the host, returned on the tensor's
    device; rows and columns past the last whole block stay 1.  ref
    sparse_masklib.py:67-96."""
    mat = matrix.detach().float().cpu().numpy()
    mask = np.ones(mat.shape, dtype=np.float32)
    row_count = (mat.shape[0] // m) * m
    col_count = (mat.shape[1] // m) * m
    for r0 in range(0, row_count, m):
        for c0 in range(0, col_count, m):
            sub = np.abs(mat[r0:r0 + m, c0:c0 + m])
            msub = np.zeros((m, m), dtype=np.float32)
            order = np.argsort(sub.reshape(-1))
            rowc: collections.Counter = collections.Counter()
            colc: collections.Counter = collections.Counter()
            for idx in order[::-1]:
                i, j = divmod(int(idx), m)
                if rowc[i] == n or colc[j] == n:
                    continue
                msub[i, j] = 1.0
                rowc[i] += 1
                colc[j] += 1
            mask[r0:r0 + m, c0:c0 + m] = msub
    return torch.from_numpy(mask).to(matrix.device)


def m4n2_2d_greedy(mat: torch.Tensor, density: float = 0.5) -> torch.Tensor:
    return mn_2d_greedy(mat, 4, 2)


_PATTERNS = {
    "m4n2_1d": m4n2_1d,
    "m4n2_2d_best": m4n2_2d_best,
    "m4n2_2d_greedy": m4n2_2d_greedy,
}


def _canonicalize(tensor: torch.Tensor, layout: Optional[str]):
    """A 2d matrix whose LAST axis is the pruned axis, and the map of a
    matrix-shaped mask back to the tensor's shape and layout.  ref
    sparse_masklib.py:145-183 (a 4d conv permuted so its input channels
    are the fast axis)."""
    shape = tensor.shape
    if tensor.dim() == 1:
        return tensor.reshape(1, -1), lambda m: m.reshape(shape)
    if tensor.dim() == 2:
        if layout == "io":  # flax Dense (in, out): prune along `in`
            return tensor.T, lambda m: m.T
        return tensor, lambda m: m.reshape(shape)
    if tensor.dim() == 3:  # (batch, in, out): prune the last axis as is
        return tensor.reshape(-1, shape[-1]), lambda m: m.reshape(shape)
    if tensor.dim() == 4:
        if layout == "hwio":  # flax Conv (h, w, in, out): prune along `in`
            mat = tensor.permute(0, 1, 3, 2).reshape(-1, shape[2])
            return mat, lambda m: m.reshape(
                shape[0], shape[1], shape[3], shape[2]).permute(0, 1, 3, 2)
        # torch conv (K, C, R, S): prune along C (ref :179-183)
        mat = tensor.permute(2, 3, 0, 1).reshape(-1, shape[1])
        return mat, lambda m: m.reshape(
            shape[2], shape[3], shape[0], shape[1]).permute(2, 3, 0, 1)
    raise ValueError(f"cannot sparsify tensor of rank {tensor.dim()}")


def create_mask(tensor: torch.Tensor, pattern: str = "m4n2_1d",
                density: float = 0.5, layout: Optional[str] = None
                ) -> torch.Tensor:
    """A {0, 1} mask of ``tensor``'s shape, dtype and device with the
    given m:n pattern.  ref sparse_masklib.py:145-183.  ``layout`` names
    the reduction (pruned) axis: ``"io"``/``"hwio"`` for flax-layout
    Dense/Conv kernels, ``None``/``"oi"``/``"oihw"`` for torch-layout
    tensors."""
    fn = _PATTERNS.get(pattern)
    if fn is None:
        raise ValueError(f"unknown sparsity pattern {pattern!r}; have "
                         f"{list(_PATTERNS)}")
    mat, restore = _canonicalize(tensor.detach(), layout)
    return restore(fn(mat, density)).to(tensor.dtype).contiguous()
