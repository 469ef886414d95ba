"""Sparse matrix containers used across FSD-Inference.

Two formats:

* :class:`CSRMatrix` — row-compressed, the natural format for the paper's
  Lambda-side SpMM (cheap row extraction for the Xsend maps, cache-friendly
  row-major traversal on CPU workers).
* :class:`BSRMatrix` — block-compressed rows with dense (bm, bn) tiles:
  the sparsity pattern is snapped to a block grid so that a kernel multiplies
  dense blocks.  ``kernels/bsr_spmm`` consumes this format.

Everything here is plain numpy — device placement happens in the compute
backend (``core/backends.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "CSRMatrix",
    "BSRMatrix",
    "random_sparse",
    "csr_from_dense",
    "bsr_from_dense",
    "bsr_from_csr",
]


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row matrix.

    ``indptr``  int32[nrows+1]
    ``indices`` int32[nnz]   column ids, sorted within each row
    ``data``    float32[nnz]
    """

    shape: Tuple[int, int]
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(column ids, values) of row ``i``."""
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def col_nnz(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.ncols)

    def nonzero_cols(self) -> np.ndarray:
        """Sorted unique column ids that contain at least one nonzero."""
        return np.unique(self.indices)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    def select_rows(self, rows: np.ndarray) -> "CSRMatrix":
        """Sub-matrix keeping only ``rows`` (global column ids preserved)."""
        rows = np.asarray(rows, dtype=np.int64)
        starts = self.indptr[rows].astype(np.int64)
        counts = (self.indptr[rows + 1] - self.indptr[rows]).astype(np.int64)
        indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        total = int(indptr[-1])
        # gather index: for each kept row, a contiguous run into data/indices
        idx = np.repeat(starts - indptr[:-1], counts) + np.arange(total)
        return CSRMatrix(
            shape=(len(rows), self.ncols),
            indptr=indptr,
            indices=self.indices[idx],
            data=self.data[idx],
        )

    def matmul_dense(self, x: np.ndarray) -> np.ndarray:
        """``self @ x`` with x dense [ncols, B] (the FSI local SpMM)."""
        out = np.zeros((self.nrows, x.shape[1]), dtype=np.result_type(self.data, x))
        for i in range(self.nrows):
            lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
            if hi > lo:
                out[i] = self.data[lo:hi] @ x[self.indices[lo:hi]]
        return out

    def matmul_dense_scatter(self, x: np.ndarray) -> np.ndarray:
        """``self @ x`` via ``np.add.at`` scatter-add.

        Kept as the bit-exact oracle for the ``numpy-csr`` compute backend;
        ``np.add.at`` is unbuffered and 10-50x slower than the segment
        formulations in :meth:`matmul_dense_fast`.
        """
        rows = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        contrib = self.data[:, None] * x[self.indices]
        out = np.zeros((self.nrows, x.shape[1]), dtype=contrib.dtype)
        np.add.at(out, rows, contrib)
        return out

    def matmul_dense_fast(self, x: np.ndarray,
                          tile_elems: int = 1 << 22) -> np.ndarray:
        """Vectorized ``self @ x`` with x dense [ncols, B].

        Uniform-nnz rows (the GraphChallenge case: every row has exactly
        ``nnz_per_row`` entries, and row subsets keep whole rows) reshape the
        gathered contributions to [nrows, k, B] and contract the k axis with a
        batched matmul — no [nnz, B] temporary, no scatter.  Ragged rows use
        a segment ``np.add.reduceat`` over the CSR row pointers, **tiled over
        the batch axis**: the contribution temporary is materialized one
        [nnz, bt] panel at a time with ``bt = tile_elems // nnz`` columns, so
        peak extra memory is bounded by ~``tile_elems`` elements (default
        4Mi ≈ 16–32MB) instead of growing as nnz·B — big-batch ragged shards
        no longer spike the worker's high-water mark.
        """
        B = x.shape[1]
        counts = np.diff(self.indptr)
        dtype = np.result_type(self.data, x)
        if self.nnz == 0:
            return np.zeros((self.nrows, B), dtype=dtype)
        if counts.size and counts[0] > 0 and np.all(counts == counts[0]):
            k = int(counts[0])
            xg = x[self.indices].reshape(self.nrows, k, B)
            return np.matmul(self.data.reshape(self.nrows, 1, k), xg)[:, 0, :]
        out = np.zeros((self.nrows, B), dtype=dtype)
        nonempty = counts > 0
        starts = self.indptr[:-1][nonempty]
        if not starts.size:
            return out
        data_col = self.data[:, None]
        bt = max(1, min(B, tile_elems // max(1, self.nnz)))
        for b0 in range(0, B, bt):
            # advanced row index + basic column slice: gathers only the
            # [nnz, bt] panel, never the full [nnz, B] temporary
            contrib = data_col * x[self.indices, b0:b0 + bt]
            out[nonempty, b0:b0 + bt] = np.add.reduceat(contrib, starts, axis=0)
        return out


@dataclasses.dataclass
class BSRMatrix:
    """Block-compressed sparse rows with dense (bm, bn) tiles.

    ``indptr``  int32[n_block_rows+1]
    ``indices`` int32[n_blocks]  block-column ids
    ``blocks``  float32[n_blocks, bm, bn]
    """

    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    indptr: np.ndarray
    indices: np.ndarray
    blocks: np.ndarray

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block_shape[1]

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def block_density(self) -> float:
        return self.n_blocks / max(1, self.n_block_rows * self.n_block_cols)

    def to_dense(self) -> np.ndarray:
        bm, bn = self.block_shape
        out = np.zeros(self.shape, dtype=self.blocks.dtype)
        for br in range(self.n_block_rows):
            for p in range(int(self.indptr[br]), int(self.indptr[br + 1])):
                bc = int(self.indices[p])
                out[br * bm : (br + 1) * bm, bc * bn : (bc + 1) * bn] = self.blocks[p]
        return out

    def padded(self, max_blocks_per_row: int | None = None):
        """Dense-padded layout for the BSR kernels.

        Returns ``(blocks [n_block_rows, K, bm, bn], cols int32[n_block_rows, K],
        counts int32[n_block_rows])`` where K = max blocks per block-row and
        padding entries point at block-col 0 with all-zero data (safe to
        multiply — contributes nothing).
        """
        counts = np.diff(self.indptr).astype(np.int32)
        k = int(max_blocks_per_row or max(1, counts.max(initial=1)))
        bm, bn = self.block_shape
        nbr = self.n_block_rows
        blocks = np.zeros((nbr, k, bm, bn), dtype=self.blocks.dtype)
        cols = np.zeros((nbr, k), dtype=np.int32)
        if self.n_blocks:
            br_idx = np.repeat(np.arange(nbr), counts)
            slot = np.arange(self.n_blocks) - np.repeat(
                self.indptr[:-1].astype(np.int64), counts
            )
            blocks[br_idx, slot] = self.blocks
            cols[br_idx, slot] = self.indices
        return blocks, cols, counts


def csr_from_dense(dense: np.ndarray) -> CSRMatrix:
    nrows, _ = dense.shape
    rows, cols = np.nonzero(dense)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRMatrix(
        shape=dense.shape,
        indptr=indptr,
        indices=cols.astype(np.int32),
        data=dense[rows, cols].astype(dense.dtype),
    )


def bsr_from_dense(dense: np.ndarray, block_shape: Tuple[int, int]) -> BSRMatrix:
    bm, bn = block_shape
    m, n = dense.shape
    if m % bm or n % bn:
        raise ValueError(f"dense shape {dense.shape} not divisible by {block_shape}")
    nbr, nbc = m // bm, n // bn
    tiled = dense.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
    mask = np.abs(tiled).sum(axis=(2, 3)) != 0
    indptr = np.zeros(nbr + 1, dtype=np.int64)
    indices, blocks = [], []
    for br in range(nbr):
        cols = np.nonzero(mask[br])[0]
        indptr[br + 1] = indptr[br] + len(cols)
        indices.append(cols)
        blocks.append(tiled[br, cols])
    indices = (
        np.concatenate(indices).astype(np.int32) if indices else np.zeros(0, np.int32)
    )
    blocks = (
        np.concatenate(blocks, axis=0)
        if blocks and sum(b.shape[0] for b in blocks)
        else np.zeros((0, bm, bn), dense.dtype)
    )
    return BSRMatrix(
        shape=dense.shape,
        block_shape=block_shape,
        indptr=indptr,
        indices=indices,
        blocks=blocks.astype(dense.dtype),
    )


def bsr_from_csr(
    csr: CSRMatrix, block_shape: Tuple[int, int], pad: bool = False
) -> BSRMatrix:
    """CSR → BSR straight from the block coordinates of each nonzero.

    Never materializes the dense matrix: every nonzero ``(r, c)`` maps to a
    block coordinate ``(r // bm, c // bn)`` and an in-block offset, the
    distinct block coordinates become the BSR structure (sorted row-major,
    like :func:`bsr_from_dense` produces), and a single vectorized scatter
    fills the block data.  Memory is O(nnz + n_blocks·bm·bn) — a 1024×65536
    worker shard with 32 nnz/row costs ~the blocks themselves, not a 256MB
    densified panel (the ROADMAP N=65536 sweep bottleneck).

    With ``pad=True`` the matrix shape is rounded up to the next block-grid
    multiple (arbitrary worker-shard shapes become legal; padding rows/cols
    are all-zero so they never contribute).  Without it, non-divisible shapes
    raise like :func:`bsr_from_dense`.
    """
    bm, bn = block_shape
    m, n = csr.shape
    if pad:
        m = -(-max(m, 1) // bm) * bm
        n = -(-max(n, 1) // bn) * bn
    elif m % bm or n % bn:
        raise ValueError(f"dense shape {csr.shape} not divisible by {block_shape}")
    nbr, nbc = m // bm, n // bn
    if csr.nnz == 0:
        return BSRMatrix(
            shape=(m, n), block_shape=block_shape,
            indptr=np.zeros(nbr + 1, dtype=np.int64),
            indices=np.zeros(0, np.int32),
            blocks=np.zeros((0, bm, bn), csr.data.dtype),
        )
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(csr.indptr))
    cols = csr.indices.astype(np.int64)
    # nnz → flat block id (row-major over the block grid) + in-block offset
    key = (rows // bm) * nbc + cols // bn
    order = np.argsort(key, kind="stable")
    uniq, inv = np.unique(key[order], return_inverse=True)
    blocks = np.zeros((uniq.size, bm, bn), dtype=csr.data.dtype)
    blocks[inv, rows[order] % bm, cols[order] % bn] = csr.data[order]
    indptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(indptr, uniq // nbc + 1, 1)
    np.cumsum(indptr, out=indptr)
    return BSRMatrix(
        shape=(m, n), block_shape=block_shape,
        indptr=indptr,
        indices=(uniq % nbc).astype(np.int32),
        blocks=blocks,
    )


def random_sparse(
    nrows: int,
    ncols: int,
    nnz_per_row: int,
    rng: np.random.Generator,
    dtype=np.float32,
    value_scale: float = 1.0,
) -> CSRMatrix:
    """Fixed-nnz-per-row random sparse matrix (GraphChallenge-style).

    The GraphChallenge synthetic DNNs (RadiX-Net) have exactly 32 nonzeros per
    row; we generalize to ``nnz_per_row`` with values in {-value_scale,
    +value_scale} like the benchmark's ±1/16-ish weights.
    """
    nnz_per_row = min(nnz_per_row, ncols)
    indptr = np.arange(nrows + 1, dtype=np.int64) * nnz_per_row
    # Vectorized sampling-without-replacement per row: draw, sort, and
    # resample rows that contain duplicates (rare for nnz << ncols).
    idx = np.sort(rng.integers(0, ncols, size=(nrows, nnz_per_row)), axis=1)
    for _ in range(64):
        dup_rows = np.nonzero((np.diff(idx, axis=1) == 0).any(axis=1))[0]
        if dup_rows.size == 0:
            break
        idx[dup_rows] = np.sort(
            rng.integers(0, ncols, size=(dup_rows.size, nnz_per_row)), axis=1
        )
    else:  # pathological nnz≈ncols: fall back to exact per-row choice
        for i in np.nonzero((np.diff(idx, axis=1) == 0).any(axis=1))[0]:
            idx[i] = np.sort(rng.choice(ncols, size=nnz_per_row, replace=False))
    indices = idx.reshape(-1).astype(np.int32)
    signs = rng.integers(0, 2, size=nrows * nnz_per_row) * 2 - 1
    data = (signs * value_scale).astype(dtype)
    return CSRMatrix(
        shape=(nrows, ncols), indptr=indptr, indices=indices, data=data
    )
