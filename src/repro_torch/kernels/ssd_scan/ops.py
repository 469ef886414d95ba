"""Wrapper of the hand-written chunked SSD scan kernels in
``csrc/ssd_scan.cu``.

``ssd(x [B,H,L,P], dt [B,H,L], A [H], Bm, Cm [B,G,L,N], *, chunk=128)``
→ ``(y [B,H,L,P] in x's dtype, state [B,H,P,N] fp32)``: the Mamba-2 SSD
recurrence ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t ⊗ B_t``, ``y_t = C_t · S_t``
over the whole sequence, evaluated chunk by chunk, with B and C read at
group ``h // (H / G)``.  x, Bm and Cm are fp32 or bf16 alike; ``dt`` and
``A`` are cast to fp32, as the TPU kernel casts them.  ``L`` must be a
multiple of ``chunk``, as the reference asserts.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the kernels, or the wrapper raises.  There is no fallback from one
to the other.  One call on the card makes four CUDA launches, one for each
phase of ``ssd_chunked`` (``PHASES``; ``csrc/ssd_scan.cu::grid_of`` sets
their grids): C·B once per group and chunk, each chunk's own state, the
states passed from chunk to chunk, and y.  The wrapper allocates their fp32
scratch with ``torch.empty``: C·B ``[B,G,nc,Q,Q]``, the within-chunk
log-decay ``[B,H,nc,Q]`` and the chunk states ``[B,H,nc,P,N]`` (``nc = L /
Q``), and raises if any launch returns a CUDA error (``launch`` is that
call alone, uncounted, for any build of the library).  The kernels are
compiled with ``nvcc`` for ``sm_90a`` at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  ``LAUNCHES`` counts the calls that reach the
kernels (one a call, never the plain version's calls).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["ssd", "launch", "LAUNCHES", "SHAPES", "PHASES",
           "check_kernel_operands", "load_library", "library_path"]

LAUNCHES = {"ssd_scan": 0}
# (P, N) the kernel is built for: the reference's test shapes and
# mamba2-370m's (64, 128)
SHAPES = ((16, 8), (32, 16), (32, 64), (64, 32), (64, 128))
MAX_CHUNK = 256             # two levels of the kernel's blocked cumsum
# the four kernels of one call, in launch order
PHASES = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
          "ssd_out_kernel")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_HERE = Path(__file__).resolve().parent
_lib: Optional[ctypes.CDLL] = None
_SOURCE = _HERE / "csrc" / "ssd_scan.cu"


def library_path() -> Path:
    return _build.library_path(_SOURCE, _HERE / "build", "libssd_scan.so")


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                    i, i, i, i, i, p]
    lib.ssd_scan_launch.restype = i
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        _lib = _build.load(_SOURCE, library_path(), _configure)
    return _lib


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"x must be [B,H,L,P] and Bm, Cm [B,G,L,N] alike, got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, H, L, P = x.shape
    bb, G, bl, N = Bm.shape
    if bb != B or bl != L or G < 1 or H % G:
        raise ValueError(f"Bm {tuple(Bm.shape)} does not fit x {tuple(x.shape)}: "
                         f"need [B, G, L, N] with G | H")
    if tuple(dt.shape) != (B, H, L) or tuple(A.shape) != (H,):
        raise ValueError(f"dt must be [B,H,L] = {(B, H, L)} and A [H] = {(H,)}, "
                         f"got {tuple(dt.shape)} and {tuple(A.shape)}")
    if chunk < 1 or L < 1 or L % chunk:
        raise ValueError(f"L={L} must be a positive multiple of chunk={chunk}")


def check_kernel_operands(x, Bm, chunk: int) -> None:
    """What the CUDA kernel takes beyond what ``ssd`` takes: (P, N) in
    ``SHAPES`` and ``chunk <= MAX_CHUNK``.  ``ssd`` calls it on the CUDA
    path only."""
    P, N = x.shape[-1], Bm.shape[-1]
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd's kernel takes (P, N) in {SHAPES}, got "
                         f"({P}, {N})")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd's kernel takes chunk <= {MAX_CHUNK}, got {chunk}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes (a
    view at an offset): the kernels load 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan on ``x``'s device (see the module docstring)."""
    _check(x, dt, A, Bm, Cm, chunk)
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    dev = x.device
    if dev.type == "cpu":
        y, state = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
        return y.to(x.dtype), state
    if dev.type != "cuda":
        raise ValueError(f"ssd runs on cpu or cuda, not {dev.type}")
    check_kernel_operands(x, Bm, chunk)
    y, state = launch(load_library(), x, dt, A, Bm, Cm, chunk)
    LAUNCHES["ssd_scan"] += 1
    return y, state


def launch(lib: ctypes.CDLL, x: torch.Tensor, dt: torch.Tensor,
           A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lib``'s four launches on CUDA operands that ``ssd`` has checked
    (``dt`` and ``A`` fp32 and contiguous), on the current stream; not
    counted in ``LAUNCHES``."""
    B, H, L, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    nc = L // chunk
    dev = x.device
    x, Bm, Cm = _aligned(x), _aligned(Bm), _aligned(Cm)
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=dev)
    state = torch.empty((B, H, P, N), **f32)
    cb = torch.empty((B, G, nc, chunk, chunk), **f32)
    lbuf = torch.empty((B, H, nc, chunk), **f32)
    sbuf = torch.empty((B, H, nc, P, N), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), cb.data_ptr(),
            lbuf.data_ptr(), sbuf.data_ptr(), B, H, G, L, P, N, chunk,
            _DTYPES[x.dtype], stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan_launch failed: CUDA error {err} ({msg})")
    return y, state
