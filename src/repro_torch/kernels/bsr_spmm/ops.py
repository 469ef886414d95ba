"""Wrappers of the hand-written BSR SpMM kernels in ``csrc/bsr_spmm.cu``.

``bsr_spmm``       — one worker-layer: blocks [NBR,K,bm,bn], cols [NBR,K],
                     x [N,B] → y [NBR*bm, B].
``bsr_spmm_fleet`` — the whole fleet in one launch: blocks [P,NBR,K,bm,bn],
                     cols [P,NBR,K], counts [P,NBR], x [P,N,B]
                     → y [P, NBR*bm, B]; row (p, r) stops at counts[p, r]
                     (the reference's ``bsr_spmm_fleet_fused``, also under
                     that name here).
``bsr_spmm_fleet_fused_sharded`` — the fleet split into device blocks (lists
                     of ``bsr_spmm_fleet``'s operands, one entry a shard of
                     the worker axis, each on its own device): one fleet
                     launch a block.
``bsr_spmm_fleet_sharded`` — the same lists without ``counts``: one
                     ``bsr_spmm`` launch a worker of every block (the
                     reference's vmap within a shard).
``sparse_layer_apply`` — one GraphChallenge layer of an offline
                     ``core.sparse.BSRMatrix`` through ``bsr_spmm``
                     (``prepare_bsr_operands`` pads it for the kernel).

Both compute ``clip(Σ_k blocks[.., k] @ x[cols[.., k]*bn : +bn] + bias, 0,
clip)``.  A tensor on the CPU goes to the plain version in ``ref.py``; a
CUDA tensor goes to the kernel, or the wrapper raises.  There is no fallback
from one to the other.

The kernels skip zero weights, except in a block whose x slice holds an
Inf or a NaN: that block is walked over every term, so an output is NaN
exactly where the plain version's is (a ``0 * inf`` or a NaN among its
terms).  The one exception is the fleet kernel's padding slots past a
row's count, which it never reads and the plain version multiplies (all
zero, over column block 0 of x): with an Inf or NaN in x's first ``bn``
rows the fleet kernel leaves out those ``0 * inf`` terms, as the
reference's count-bounded Pallas body does.  On finite operands the
kernels agree with the plain versions to 1e-5 and the fleet kernel equals
the per-worker kernel bit for bit.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into a
shared library with a plain C interface, under ``build/<hash of the
sources and flags>/`` beside this file, and loaded with ``ctypes``.
``LAUNCHES`` counts each kernel's launches (never the plain versions' calls),
so a caller can show that a run went through the kernels.  ``layer_work``
counts the bytes and FLOPs that one layer op needs on given operands, for a
roofline bound.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_fleet_ref, bsr_spmm_fused_ref

__all__ = ["bsr_spmm", "bsr_spmm_fleet", "bsr_spmm_fleet_fused",
           "bsr_spmm_fleet_sharded",
           "bsr_spmm_fleet_fused_sharded", "prepare_bsr_operands",
           "sparse_layer_apply", "layer_work", "LAUNCHES",
           "MAX_BLOCK", "load_library", "library_path"]

LAUNCHES = {"bsr_spmm_fused": 0, "bsr_spmm_fleet": 0}
MAX_BLOCK = 32  # largest bm and bn the kernels are written for

_HERE = Path(__file__).resolve().parent
_lib: Optional[ctypes.CDLL] = None
_SOURCE = _HERE / "csrc" / "bsr_spmm.cu"


def library_path() -> Path:
    """Where the built library lives: keyed on the source bytes and the
    compiler flags, so an edited source never loads a stale build."""
    return _build.library_path(_SOURCE, _HERE / "build", "libbsr_spmm.so")


def _configure(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bsr_spmm_fused_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                          f, f, p]
    lib.bsr_spmm_fused_launch.restype = i
    lib.bsr_spmm_fleet_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                          i, i, f, f, p]
    lib.bsr_spmm_fleet_launch.restype = i
    lib.bsr_spmm_error_string.argtypes = [i]
    lib.bsr_spmm_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library.
    The first call hashes the source; later calls return the loaded
    library without touching the disk."""
    global _lib
    if _lib is None:
        _lib = _build.load(_SOURCE, library_path(), _configure)
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_block(bm: int, bn: int) -> None:
    if not (1 <= bm <= MAX_BLOCK and 1 <= bn <= MAX_BLOCK):
        raise ValueError(f"block shape ({bm}, {bn}) not supported: the kernels "
                         f"take 1 <= bm, bn <= {MAX_BLOCK}")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        msg = lib.bsr_spmm_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({msg})")


def bsr_spmm(blocks: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             bias: float, clip: float = 32.0) -> torch.Tensor:
    """One worker-layer on ``x``'s device (see the module docstring)."""
    dev = x.device
    _check("x", x, torch.float32, 2, dev)
    _check("blocks", blocks, torch.float32, 4, dev)
    _check("cols", cols, torch.int32, 2, dev)
    nbr, k, bm, bn = blocks.shape
    if tuple(cols.shape) != (nbr, k):
        raise ValueError(f"cols shape {tuple(cols.shape)} != {(nbr, k)}")
    _check_block(bm, bn)
    if dev.type == "cpu":
        return bsr_spmm_fused_ref(blocks, cols, x, bias, clip)
    if dev.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cpu or cuda, not {dev.type}")
    n, b = x.shape
    y = torch.empty((nbr * bm, b), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    _launch("bsr_spmm_fused_launch", dev, blocks.data_ptr(), cols.data_ptr(),
            x.data_ptr(), y.data_ptr(), nbr, k, bm, bn, n, b,
            float(bias), float(clip))
    LAUNCHES["bsr_spmm_fused"] += 1
    return y


def bsr_spmm_fleet(blocks: torch.Tensor, cols: torch.Tensor,
                   counts: torch.Tensor, x: torch.Tensor, *, bias: float,
                   clip: float = 32.0) -> torch.Tensor:
    """The whole fleet's layer on ``x``'s device (see the module docstring):
    the reference's ``bsr_spmm_fleet_fused`` (one launch over every
    worker), not its ``bsr_spmm_fleet``, which vmaps the per-worker kernel."""
    dev = x.device
    _check("x", x, torch.float32, 3, dev)
    _check("blocks", blocks, torch.float32, 5, dev)
    _check("cols", cols, torch.int32, 3, dev)
    _check("counts", counts, torch.int32, 2, dev)
    p, nbr, k, bm, bn = blocks.shape
    if tuple(cols.shape) != (p, nbr, k):
        raise ValueError(f"cols shape {tuple(cols.shape)} != {(p, nbr, k)}")
    if tuple(counts.shape) != (p, nbr):
        raise ValueError(f"counts shape {tuple(counts.shape)} != {(p, nbr)}")
    if x.shape[0] != p:
        raise ValueError(f"x has {x.shape[0]} workers, blocks {p}")
    _check_block(bm, bn)
    if dev.type == "cpu":
        return bsr_spmm_fleet_ref(blocks, cols, counts, x, bias, clip)
    if dev.type != "cuda":
        raise ValueError(f"bsr_spmm_fleet runs on cpu or cuda, not {dev.type}")
    n, b = x.shape[1:]
    y = torch.empty((p, nbr * bm, b), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    _launch("bsr_spmm_fleet_launch", dev, blocks.data_ptr(), cols.data_ptr(),
            counts.data_ptr(), x.data_ptr(), y.data_ptr(), p, nbr, k, bm, bn,
            n, b, float(bias), float(clip))
    LAUNCHES["bsr_spmm_fleet"] += 1
    return y


# the reference's name for the one-launch fleet op
bsr_spmm_fleet_fused = bsr_spmm_fleet


def bsr_spmm_fleet_fused_sharded(blocks, cols, counts, x, *, bias: float,
                                 clip: float = 32.0) -> list:
    """The fleet layer over device blocks: ``blocks``, ``cols``, ``counts``
    and ``x`` are lists with one entry a shard of the worker axis (the
    reference's ``bsr_spmm_fleet_fused_sharded`` under ``shard_map``), each
    shard's operands on its own device.  One :func:`bsr_spmm_fleet` a shard;
    returns the shards' ``y`` in order, each on its device.  Pad workers
    (``counts`` 0) cost no K step."""
    return [bsr_spmm_fleet(b, c, n, xx, bias=bias, clip=clip)
            for b, c, n, xx in zip(blocks, cols, counts, x)]


def bsr_spmm_fleet_sharded(blocks, cols, x, *, bias: float,
                           clip: float = 32.0) -> list:
    """The fleet layer over device blocks, one :func:`bsr_spmm` a worker of
    every shard (the reference's ``bsr_spmm_fleet_sharded``: a vmap of the
    per-worker body inside each shard).  Same lists as
    :func:`bsr_spmm_fleet_fused_sharded` without ``counts``; gives the same
    bits, since the fleet kernel equals the per-worker kernel."""
    return [torch.stack([bsr_spmm(b[m], c[m], xx[m], bias=bias, clip=clip)
                         for m in range(b.shape[0])])
            for b, c, xx in zip(blocks, cols, x)]


def prepare_bsr_operands(bsr, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's padded operands of an offline ``BSRMatrix``: ``blocks``
    fp32 ``[NBR, K, bm, bn]`` and ``cols`` int32 ``[NBR, K]`` on
    ``device`` (``BSRMatrix.padded``: padding slots are zero blocks at
    column block 0)."""
    from repro_torch.core.backends import _require_device

    blocks, cols, _ = bsr.padded()
    device = _require_device("prepare_bsr_operands", device)
    return (torch.as_tensor(blocks, dtype=torch.float32, device=device),
            torch.as_tensor(cols, dtype=torch.int32, device=device))


def sparse_layer_apply(bsr, x, bias: float, clip: float = 32.0,
                       device="cuda") -> torch.Tensor:
    """One GraphChallenge layer, ``y = clip(relu(W·x + bias), 0, clip)``,
    of an offline ``BSRMatrix`` ``W`` on ``x [N, B]`` (an array or a
    tensor, taken as fp32): the hand-written ``bsr_spmm`` kernel on the
    card (``device="cuda"``, the default, which raises where no card is
    present), its plain version with ``device="cpu"``.  Returns ``y
    [NBR·bm, B]`` on ``device``."""
    from repro_torch.core.backends import _require_device

    device = _require_device("sparse_layer_apply", device)
    blocks, cols = prepare_bsr_operands(bsr, device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
    return bsr_spmm(blocks, cols, x, bias=bias, clip=clip)


def layer_work(blocks: torch.Tensor, cols: torch.Tensor, counts: torch.Tensor,
               b: int) -> tuple[int, int]:
    """``(bytes, flops)`` that the layer op needs on these operands at batch
    ``b``: the fleet layout (``blocks [P,NBR,K,bm,bn]``, ``cols [P,NBR,K]``,
    ``counts [P,NBR]``) or one worker's (one dim fewer each).

    Bytes: each real block (the slots below ``counts``; the rest are zero
    padding) and its column id, ``counts``, each x block row that a real
    block references and y, once each, in fp32 and int32.  FLOPs: one FMA
    (2 FLOPs) a batch column for each nonzero weight of the real blocks;
    the zeros inside a block need none.
    """
    if blocks.dim() == 4:
        blocks, cols, counts = blocks[None], cols[None], counts[None]
    p, nbr, k, bm, bn = blocks.shape
    real = torch.arange(k, device=cols.device) < counts[..., None].long()
    n_real = int(real.sum())
    key = (torch.arange(p, device=cols.device)[:, None, None] * (1 << 31)
           + cols.long())
    x_blocks = int(torch.unique(key[real]).numel())
    nbytes = (n_real * (bm * bn + 1) + counts.numel() + x_blocks * bn * b
              + p * nbr * bm * b) * 4
    nnz = int(torch.count_nonzero(blocks, dim=(-2, -1))[real].sum())
    return nbytes, 2 * nnz * b
