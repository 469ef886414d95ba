"""Message payload encoding for the FSI channels (paper §III-C1).

Intermediate results ``x̄_mn^{k-1}`` (selected rows of the activation matrix)
are serialized as::

    header: layer(u32) | src(u32) | n_rows(u32) | batch(u32) | seq(u32) | total(u32)
    body:   row_ids int32[n_rows] | values float32[n_rows, batch]

then zlib-compressed (paper §IV-B: "Both FSD-Inf-Queue and FSD-Inf-Object
utilize ZLIB compression to reduce the communication volume").

``pack_rows`` splits a row set into byte strings that each stay under the
pub-sub payload cap, using the paper's NNZ heuristic to estimate how many
rows fit per message before compressing (grouping and compressing rows only
once per message).  ``pack_rows_fleet`` is the batched entry point: it packs
every worker's outgoing row-sets for one layer in a single call, sharing one
deflate-state pool across all chunks — the byte streams are identical to P
independent ``pack_rows`` calls (billing invariance), only the Python-level
per-chunk setup cost is amortized.

``decode_chunk`` is zero-copy: the returned ``row_ids``/``values`` are
read-only views into the decompressed body.  The single place the FSI recv
paths materialize a copy is the scatter into the destination buffer.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["encode_chunk", "decode_chunk", "pack_rows", "pack_rows_fleet",
           "Chunk"]

_HEADER = struct.Struct("<6I")
_ZLIB_LEVEL = 1


def _buffer(arr: np.ndarray, dtype) -> object:
    """Zero-copy buffer view when the array is already contiguous+typed
    (the pack_rows fast path); otherwise one conversion copy."""
    if arr.dtype != dtype or not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr, dtype=dtype)
    return arr.data


class _CompressPool:
    """Deflate-state provider shared by every chunk of one batched pack.

    Centralizing the level here keeps every chunk's stream byte-identical
    whichever entry point packed it — the wire volume (and everything billed
    over it) cannot drift between the per-worker and fleet-batched send
    paths.  States are provisioned fresh per chunk: ``compressobj(1)`` is
    ~3µs while ``compressobj.copy()`` duplicates the full deflate window
    (~500µs measured), so cloning a template would be a pessimization.
    """

    def __init__(self, level: int = _ZLIB_LEVEL):
        self._level = level

    def fresh(self):
        return zlib.compressobj(self._level)


def encode_chunk(
    layer: int, src: int, row_ids: np.ndarray, values: np.ndarray,
    seq: int, total: int, compress: bool = True,
    _pool: Optional[_CompressPool] = None,
) -> bytes:
    assert values.shape[0] == row_ids.shape[0]
    header = _HEADER.pack(layer, src, len(row_ids), values.shape[1], seq, total)
    ids_buf = _buffer(row_ids, np.int32)
    val_buf = _buffer(values, np.float32)
    if not compress:
        return header + bytes(ids_buf) + bytes(val_buf)
    # stream the pieces through one compressobj: no concatenated body temp
    co = _pool.fresh() if _pool is not None else zlib.compressobj(_ZLIB_LEVEL)
    return b"".join(
        (co.compress(header), co.compress(ids_buf), co.compress(val_buf),
         co.flush())
    )


def decode_chunk(blob: bytes, compressed: bool = True) -> Tuple[int, int, np.ndarray, np.ndarray, int, int]:
    """Decode one chunk; ``row_ids``/``values`` are zero-copy read-only views
    into the (decompressed) body — they stay valid as long as the caller
    holds them, and any mutation must copy first (the recv scatter is the
    one site that materializes them, into the destination buffer)."""
    body = zlib.decompress(blob) if compressed else blob
    layer, src, n_rows, batch, seq, total = _HEADER.unpack_from(body, 0)
    off = _HEADER.size
    row_ids = np.frombuffer(body, dtype=np.int32, count=n_rows, offset=off)
    off += 4 * n_rows
    values = np.frombuffer(body, dtype=np.float32, count=n_rows * batch, offset=off)
    row_ids.flags.writeable = False   # bytes-backed already; bytearray too
    values.flags.writeable = False
    return layer, src, row_ids, values.reshape(n_rows, batch), seq, total


class Chunk(bytes):
    """A byte-string message; subclass only to carry the uncompressed size."""

    raw_bytes: int

    def __new__(cls, data: bytes, raw_bytes: int):
        obj = super().__new__(cls, data)
        obj.raw_bytes = raw_bytes
        return obj


def _pack_rows_one(
    layer: int,
    src: int,
    row_ids: np.ndarray,
    values: np.ndarray,
    max_payload: int,
    compress: bool,
    est_compression_ratio: float,
    pool: Optional[_CompressPool],
) -> List[Chunk]:
    """The pack core shared by ``pack_rows`` and ``pack_rows_fleet``."""
    n_rows, batch = values.shape
    if n_rows == 0:
        return []
    # normalize dtype/layout ONCE so every emitted slice is a zero-copy
    # contiguous view inside encode_chunk (no per-chunk ascontiguousarray)
    row_ids = np.ascontiguousarray(row_ids, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    bytes_per_row = 4 + 4 * batch
    est = bytes_per_row * (est_compression_ratio if compress else 1.0)
    rows_per_msg = max(1, int(max_payload / max(est, 1e-9)))
    if n_rows <= rows_per_msg:
        # Single-message fast path (the overwhelmingly common case at high
        # P, where per-target payloads are small): encode once with the
        # final (seq=0, total=1) framing and keep it if it fits — the split
        # machinery below would compress the same rows twice.
        blob = encode_chunk(layer, src, row_ids, values, 0, 1, compress,
                            _pool=pool)
        if len(blob) <= max_payload or n_rows == 1:
            return [Chunk(blob, raw_bytes=_HEADER.size + n_rows * bytes_per_row)]
    chunks: List[Tuple[np.ndarray, np.ndarray]] = []

    # Oversized trial encodes (adversarial entropy beats the NNZ estimate)
    # are re-split on an explicit work stack — LIFO with the right half
    # pushed first keeps row order, and the depth is bounded by the stack,
    # not the Python recursion limit.
    work: List[Tuple[np.ndarray, np.ndarray]] = [
        (row_ids[lo: lo + rows_per_msg], values[lo: lo + rows_per_msg])
        for lo in reversed(range(0, n_rows, rows_per_msg))
    ]
    while work:
        ids, vals = work.pop()
        blob = encode_chunk(layer, src, ids, vals, 0, 0, compress, _pool=pool)
        if len(blob) > max_payload and len(ids) > 1:
            mid = len(ids) // 2
            work.append((ids[mid:], vals[mid:]))
            work.append((ids[:mid], vals[:mid]))
        else:
            chunks.append((ids, vals))

    total = len(chunks)
    out: List[Chunk] = []
    for seq, (ids, vals) in enumerate(chunks):
        blob = encode_chunk(layer, src, ids, vals, seq, total, compress,
                            _pool=pool)
        out.append(Chunk(blob, raw_bytes=_HEADER.size + len(ids) * bytes_per_row))
    return out


def pack_rows(
    layer: int,
    src: int,
    row_ids: np.ndarray,
    values: np.ndarray,
    max_payload: int,
    compress: bool = True,
    est_compression_ratio: float = 0.45,
) -> List[Chunk]:
    """Split (row_ids, values) into ≤max_payload byte strings.

    The NNZ-count heuristic sizes the first split; if a compressed chunk
    still exceeds the cap (adversarial entropy) it is halved again on the
    work stack until it fits or is a single row.
    """
    return _pack_rows_one(layer, src, row_ids, values, max_payload, compress,
                          est_compression_ratio, pool=None)


def pack_rows_fleet(
    jobs: Sequence[Tuple[int, int, np.ndarray, np.ndarray]],
    max_payload: int,
    compress: bool = True,
    est_compression_ratio: float = 0.45,
) -> Iterator[List[Chunk]]:
    """Batched ``pack_rows``: pack every (layer, src, row_ids, values) job of
    one fleet layer in a single call.

    One deflate-state pool serves every chunk of every job, and the jobs are
    packed lazily in order — the produced byte strings are identical to
    ``[pack_rows(*job, max_payload, ...) for job in jobs]`` (asserted in
    ``tests/test_faas_services.py``), so message counts, wire bytes, and all
    billing quantized over them are invariant to which entry point packed
    the layer.
    """
    pool = _CompressPool() if compress else None
    for layer, src, row_ids, values in jobs:
        yield _pack_rows_one(layer, src, row_ids, values, max_payload,
                             compress, est_compression_ratio, pool=pool)
