"""Wrapper of the hand-written flash-attention prefill kernel in
``csrc/flash_attention.cu``.

``mha(q [B,H,Sq,D], k, v [B,KV,Sk,D], *, causal=True)`` → ``o [B,H,Sq,D]``
in q's dtype: softmax attention of every query row over the keys, causal
top-left aligned (query ``i`` sees keys ``j <= i``, with no offset when
``Sq != Sk``) or full, the G = H / KV query heads of a KV head sharing it.

``block_q`` and ``block_k`` keep the reference's argument rule
(``Sq % min(block_q, Sq) == 0`` and the same for ``Sk``), so the port
accepts what the reference accepts; they set no tile of the CUDA kernel,
whose result does not depend on them.

The dtype picks the CUDA kernel: bf16 inputs go to a tensor-core kernel
(TMA loads, ``wgmma`` for q·kᵀ and for p·v, with the fp32 p split exactly
into three bf16 pieces), fp32 inputs to a scalar fp32 kernel.  Both keep p
in fp32 for p·v, as the reference does.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to a kernel, or the wrapper raises.  There is no fallback from one
to the other.  The kernel is compiled with ``nvcc`` for ``sm_90a`` at first
use (``kernels/_build.py``) and loaded with ``ctypes``.  ``LAUNCHES``
counts the kernel's launches (never the plain version's calls).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["mha", "LAUNCHES", "HEAD_DIMS", "check_kernel_operands",
           "load_library", "library_path"]

LAUNCHES = {"flash_attention": 0}
HEAD_DIMS = (64, 128)       # head dims the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_HERE = Path(__file__).resolve().parent
_lib: Optional[ctypes.CDLL] = None
_SOURCE = _HERE / "csrc" / "flash_attention.cu"


def library_path() -> Path:
    return _build.library_path(_SOURCE, _HERE / "build",
                               "libflash_attention.so")


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           i, ctypes.c_float, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        _lib = _build.load(_SOURCE, library_path(), _configure)
    return _lib


def _check(q, k, v, block_q: int, block_k: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    B, H, Sq, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    kb, kv, sk, kd = k.shape
    if kb != B or kd != D or kv < 1 or H % kv or Sq < 1 or sk < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}: "
                         f"need [B, KV, Sk>=1, D] with KV | H")
    bq, bk = min(block_q, Sq), min(block_k, sk)
    if bq < 1 or bk < 1 or Sq % bq or sk % bk:
        raise ValueError(f"Sq={Sq} and Sk={sk} must be multiples of "
                         f"min(block_q, Sq)={bq} and min(block_k, Sk)={bk}")


def check_kernel_operands(q, k, v) -> None:
    """What the CUDA kernels take beyond what ``mha`` takes: a head dim in
    ``HEAD_DIMS``, and operands whose base is 16-byte aligned and whose row
    and head strides are multiples of 16 bytes, as the fp32 kernel's 16-byte
    loads and the bf16 kernel's TMA tensor maps need.  ``mha`` calls it on
    the CUDA path only."""
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"mha's kernel takes D in {HEAD_DIMS}, got D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel")
        stride = t.stride()
        if (stride[1] * t.element_size()) % 16 or (stride[2] * t.element_size()) % 16:
            raise ValueError(f"{name}'s row and head strides must be multiples "
                             f"of 16 bytes for the kernel, got {stride}")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, block_q: int = 128,
        block_k: int = 128) -> torch.Tensor:
    """Prefill attention on ``q``'s device (see the module docstring)."""
    _check(q, k, v, block_q, block_k)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"mha runs on cpu or cuda, not {dev.type}")
    check_kernel_operands(q, k, v)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
            Sq, Sk, D, int(bool(causal)), _DTYPES[q.dtype],
            1.0 / math.sqrt(D), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["flash_attention"] += 1
    return out
