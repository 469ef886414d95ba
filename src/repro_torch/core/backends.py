"""Pluggable backends: the FSI per-layer SpMM (``compute``) and the
serving engine's per-step decode attention (``attention``).

Every simulated Lambda runs the same inner loop per layer: a sparse
matrix–panel product ``z = W_local @ x_buf`` followed by the GraphChallenge
epilogue ``y = clip(relu(z + bias), 0, 32)``.  The *billed* cost of that work
is fixed by :class:`repro_torch.faas.worker.ComputeModel` (FLOPs →
Lambda-seconds), but the *host* wall-clock of the simulator is whatever
backend actually runs the numbers.  This module makes that choice pluggable:

* ``numpy-csr``  — the seed's ``np.add.at`` scatter-add CSR SpMM, kept
  verbatim as the bit-exact oracle.
* ``numpy-fast`` — segment formulation (uniform-row batched matmul with a
  ``np.add.reduceat`` ragged fallback); same math, 5-30x faster on
  GraphChallenge shapes.
* ``torch-bsr`` (the default) — the hand-written CUDA kernels in
  ``kernels/bsr_spmm``: offline ``bsr_from_csr(pad=True)`` + ``padded()``
  artifact prep per worker-layer, the fused bias+ReLU+clip kernel per
  worker, and a fleet mode that stacks every worker's panel on the device so
  ONE kernel launch serves the whole simulated fleet per layer.  It runs on
  ``"cuda"`` unless constructed with ``device="cpu"``, where the kernels'
  plain PyTorch versions run instead.
* ``torch-bsr-sharded`` — the same fleet panel split over a worker "mesh",
  a list of devices (``launch.mesh.make_worker_mesh``): the worker axis is
  padded with zero workers to a multiple of the mesh size D, and each
  device holds and runs its block of ``p_pad / D`` workers, one fleet
  kernel launch a block (``dispatch="fused"``) or one per-worker kernel
  launch a worker (``dispatch="vmap"``).  ``run_fsi(..., mesh=...)``
  threads the mesh through ``with_mesh``.

Backends only change how the arithmetic is executed — FLOP charging, message
accounting and memory high-water marks are computed by the caller from the
CSR shard itself, so billed cost is identical across backends by
construction (asserted in ``tests/test_torch_fsi.py``).

The attention backends (``DenseRefAttention``, ``ChunkedLseAttention``,
``TorchSplitKAttention``) sit below, mirroring the reference's
decode-attention registry; ``torch-splitk``, the hand-written CUDA kernel
of ``kernels/decode_attention``, is the attention kind's default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparse import CSRMatrix, bsr_from_csr
from repro_torch.data.graphchallenge import ACTIVATION_CLIP, relu_bias_threshold
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import decode_mha
from repro_torch.models.attention import decode_attention, decode_attention_dense

__all__ = [
    "ComputeBackend",
    "NumpyCsrBackend",
    "NumpyFastBackend",
    "TorchBsrBackend",
    "TorchBsrShardedBackend",
    "BACKEND_NAMES",
    "KVCacheLayout",
    "cache_layout_for",
    "AttentionBackend",
    "DenseRefAttention",
    "ChunkedLseAttention",
    "TorchSplitKAttention",
    "SPLITK_BLOCK_K_TABLE",
    "ATTENTION_BACKEND_NAMES",
    "attention_backend_for",
    "get_backend",
]


class ComputeBackend(Protocol):
    """One worker-layer SpMM + fused epilogue, with optional fleet batching."""

    name: str

    def prepare(self, W: CSRMatrix) -> Any:
        """Offline per-worker-layer artifact prep (unbilled, like the paper's
        a-priori partitioning/map construction)."""
        ...

    def apply(self, state: Any, x: np.ndarray, bias: float) -> np.ndarray:
        """``clip(relu(W @ x + bias), 0, 32)`` for one worker."""
        ...

    def fleet_prepare_all(
        self, layer_states: Sequence[Sequence[Any]]
    ) -> Optional[List[Any]]:
        """Optional: stack per-layer states [layer][worker] into one batched
        panel per layer.  ``None`` means no fleet mode (per-worker apply)."""
        ...

    def fleet_apply(
        self, fleet_state: Any, xs: Sequence[np.ndarray], bias: float
    ) -> List[np.ndarray]:
        """One dispatch for the whole fleet's layer-k panels."""
        ...


class _NumpyBackend:
    @property
    def state_key(self) -> str:
        return self.name

    def prepare(self, W: CSRMatrix) -> CSRMatrix:
        return W

    def fleet_prepare_all(self, layer_states):
        return None

    def fleet_apply(self, fleet_state, xs, bias):  # pragma: no cover
        raise NotImplementedError(f"{self.name} has no fleet mode")


class NumpyCsrBackend(_NumpyBackend):
    """Seed behavior: scatter-add CSR SpMM (the parity oracle)."""

    name = "numpy-csr"

    def apply(self, state: CSRMatrix, x: np.ndarray, bias: float) -> np.ndarray:
        return relu_bias_threshold(state.matmul_dense_scatter(x), bias)


class NumpyFastBackend(_NumpyBackend):
    """Segment-reduce CSR SpMM — no ``np.add.at``."""

    name = "numpy-fast"

    def apply(self, state: CSRMatrix, x: np.ndarray, bias: float) -> np.ndarray:
        return relu_bias_threshold(state.matmul_dense_fast(x), bias)


@dataclasses.dataclass
class _TorchBsrLayerState:
    """Offline-prepared padded-BSR operands for one worker-layer shard.

    The host arrays are moved to the backend's device at the first
    ``apply`` and kept there (``dev``); the fleet path stacks the host
    arrays instead and never uploads them one by one."""

    blocks: np.ndarray      # f32[NBR, K, bm, bn]
    cols: np.ndarray        # i32[NBR, K]
    counts: np.ndarray      # i32[NBR] true blocks per row (BSR indptr diff)
    m: int                  # true output rows (unpadded)
    n: int                  # true input rows (unpadded)
    n_pad: int              # padded input height = NBC * bn
    dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


@dataclasses.dataclass
class _TorchBsrFleetState:
    """One layer's fleet panel: every worker's operands padded to common
    [P, NBRmax, Kmax, bm, bn] and resident on the device, so a single kernel
    launch covers the fleet (``counts`` carries each panel row's true block
    depth so the fleet kernel's K loop skips the fleet-global padding)."""

    blocks: torch.Tensor    # f32[P, NBR, K, bm, bn]
    cols: torch.Tensor      # i32[P, NBR, K]
    counts: torch.Tensor    # i32[P, NBR]
    m: List[int]
    n: List[int]
    n_pad: int


class TorchBsrBackend:
    """BSR SpMM through the CUDA kernels of ``kernels/bsr_spmm`` (fused
    bias+ReLU+clip).

    ``device="cuda"`` (the default) launches the kernels and raises when no
    CUDA device is present; ``device="cpu"`` runs the kernels' plain PyTorch
    versions, which is what the CPU tests use.  Nothing falls back from one
    to the other.
    """

    name = "torch-bsr"

    def __init__(
        self,
        block_shape: Tuple[int, int] = (32, 32),
        clip: float = ACTIVATION_CLIP,
        device: str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "torch-bsr runs on a CUDA device by default and none is "
                "available; pass TorchBsrBackend(device='cpu') to run the "
                "kernels' plain PyTorch versions on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"torch-bsr runs on cuda or cpu, not {device!r}")
        self.block_shape = tuple(block_shape)
        self.clip = clip

    @property
    def state_key(self) -> str:
        bm, bn = self.block_shape
        return f"{self.name}:{bm}x{bn}:c{self.clip}:{self.device}"

    # -- per-worker path -----------------------------------------------------

    def prepare(self, W: CSRMatrix) -> _TorchBsrLayerState:
        bsr = bsr_from_csr(W, self.block_shape, pad=True)
        blocks, cols, counts = bsr.padded()
        return _TorchBsrLayerState(
            blocks=blocks.astype(np.float32),
            cols=cols,
            counts=counts.astype(np.int32),
            m=W.nrows,
            n=W.ncols,
            n_pad=bsr.shape[1],
        )

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def apply(self, state: _TorchBsrLayerState, x: np.ndarray, bias: float) -> np.ndarray:
        from repro_torch.kernels.bsr_spmm.ops import bsr_spmm

        batch = x.shape[1]
        if state.m == 0 or batch == 0:
            return np.zeros((state.m, batch), dtype=np.float32)
        if state.dev is None:
            state.dev = (self._to_device(state.blocks),
                         self._to_device(state.cols))
        xp = np.zeros((state.n_pad, batch), dtype=np.float32)
        xp[: state.n] = x
        y = bsr_spmm(*state.dev, self._to_device(xp), bias=float(bias),
                     clip=self.clip)
        return y[: state.m].cpu().numpy()

    # -- fleet path ----------------------------------------------------------

    def _fleet_maxima(self, layer_states):
        """(nbr_max, k_max, n_pad_max) over every worker-layer state, or
        ``None`` when the fleet is empty — padding everything to these maxima
        gives every layer's panel one shape."""
        all_states = [s for layer in layer_states for s in layer]
        if not all_states:
            return None
        bn = self.block_shape[1]
        return (
            max(1, max(s.blocks.shape[0] for s in all_states)),
            max(1, max(s.blocks.shape[1] for s in all_states)),
            max(bn, max(s.n_pad for s in all_states)),
        )

    def _stack_layer(self, states, p_rows: int, nbr_max: int, k_max: int):
        """Stack one layer's per-worker operands into [p_rows, ...] host
        panels (rows beyond ``len(states)`` stay zero — inert pad workers,
        whose ``counts`` of 0 also keep the fleet kernel's K loop off them
        entirely)."""
        bm, bn = self.block_shape
        blocks = np.zeros((p_rows, nbr_max, k_max, bm, bn), dtype=np.float32)
        cols = np.zeros((p_rows, nbr_max, k_max), dtype=np.int32)
        counts = np.zeros((p_rows, nbr_max), dtype=np.int32)
        for i, s in enumerate(states):
            nbr, k = s.blocks.shape[:2]
            blocks[i, :nbr, :k] = s.blocks
            cols[i, :nbr, :k] = s.cols
            counts[i, :nbr] = s.counts
        return blocks, cols, counts

    def fleet_prepare_all(
        self, layer_states: Sequence[Sequence[_TorchBsrLayerState]]
    ) -> List[_TorchBsrFleetState]:
        """Pad every worker-layer operand to the fleet-and-depth-global maxima
        and place each layer's stacked panel on the device (offline,
        unbilled), so no layer launch pays a host→device copy of weights."""
        maxima = self._fleet_maxima(layer_states)
        if maxima is None:
            return []
        nbr_max, k_max, n_pad_max = maxima
        out: List[_TorchBsrFleetState] = []
        for states in layer_states:
            blocks, cols, counts = self._stack_layer(
                states, len(states), nbr_max, k_max)
            out.append(
                _TorchBsrFleetState(
                    blocks=self._to_device(blocks),
                    cols=self._to_device(cols),
                    counts=self._to_device(counts),
                    m=[s.m for s in states],
                    n=[s.n for s in states],
                    n_pad=n_pad_max,
                )
            )
        return out

    def fleet_apply(
        self, fleet_state: _TorchBsrFleetState, xs: Sequence[np.ndarray], bias: float
    ) -> List[np.ndarray]:
        """Pack the workers' inputs into one host panel of
        :meth:`_fleet_rows` rows (rows past ``len(xs)`` stay zero), run the
        layer (:meth:`_fleet_launch`) and cut each worker's output to its
        rows."""
        P = len(xs)
        batch = xs[0].shape[1]
        X = np.zeros((self._fleet_rows(fleet_state, P), fleet_state.n_pad, batch),
                     dtype=np.float32)
        for i, x in enumerate(xs):
            X[i, : x.shape[0]] = x
        y = self._fleet_launch(fleet_state, X, float(bias))
        return [y[i, : fleet_state.m[i]] for i in range(P)]

    def _fleet_rows(self, fleet_state, P: int) -> int:
        return P

    def _fleet_launch(self, fleet_state: _TorchBsrFleetState, X: np.ndarray,
                      bias: float) -> np.ndarray:
        from repro_torch.kernels.bsr_spmm.ops import bsr_spmm_fleet

        return bsr_spmm_fleet(
            fleet_state.blocks, fleet_state.cols, fleet_state.counts,
            self._to_device(X), bias=bias, clip=self.clip,
        ).cpu().numpy()


@dataclasses.dataclass
class _TorchBsrShardedFleetState:
    """One layer's fleet panel padded to ``p_pad`` workers (a multiple of
    the mesh size) and split into the mesh's device blocks: ``blocks[d]``,
    ``cols[d]``, ``counts[d]`` hold workers ``d * p_pad / D`` up to the next
    block, on ``mesh[d]``, from prepare time on."""

    blocks: List[torch.Tensor]  # f32[p_pad / D, NBR, K, bm, bn] each
    cols: List[torch.Tensor]    # i32[p_pad / D, NBR, K] each
    counts: List[torch.Tensor]  # i32[p_pad / D, NBR] each
    m: List[int]
    n: List[int]
    n_pad: int
    p_pad: int


class TorchBsrShardedBackend(TorchBsrBackend):
    """``torch-bsr``'s fleet mode over a worker mesh (the reference's
    ``pallas-bsr-sharded``).

    The per-worker artifacts and ``apply`` are :class:`TorchBsrBackend`'s,
    run on the mesh's first device; only the fleet dispatch differs.  The
    stacked ``[P, ...]`` panel is padded with all-zero workers to ``p_pad =
    ceil(P / D) * D`` (their ``counts`` are 0 and their outputs never read)
    and split into D blocks of ``p_pad / D`` workers, block ``d`` resident on
    ``mesh[d]``.  A layer runs every block on its device:

    * ``dispatch="fused"`` (the default) — one launch of the fleet kernel a
      block, its K loop bounded by the per-row counts;
    * ``dispatch="vmap"`` — one launch of the per-worker kernel a worker,
      the reference's vmap of the single-worker body within a shard.

    Both give the same bits, and the same as ``torch-bsr``'s fleet path.
    ``mesh`` defaults to every visible CUDA device
    (:func:`repro_torch.launch.mesh.make_worker_mesh`), resolved at first
    use, so a default backend raises there where no card is present.
    """

    name = "torch-bsr-sharded"

    def __init__(
        self,
        block_shape: Tuple[int, int] = (32, 32),
        clip: float = ACTIVATION_CLIP,
        mesh: Optional[Sequence[Any]] = None,
        dispatch: str = "fused",
    ):
        if dispatch not in ("fused", "vmap"):
            raise ValueError(
                f"dispatch must be 'fused' or 'vmap', got {dispatch!r}")
        self.block_shape = tuple(block_shape)
        self.clip = clip
        self.dispatch = dispatch
        self._mesh = None if mesh is None else [
            _require_device(self.name, d) for d in mesh]
        if self._mesh is not None and not self._mesh:
            raise ValueError("a worker mesh needs at least one device")

    @property
    def mesh(self) -> List[torch.device]:
        if self._mesh is None:
            from repro_torch.launch.mesh import make_worker_mesh

            self._mesh = make_worker_mesh()
        return self._mesh

    @property
    def device(self) -> torch.device:
        """Where the per-worker path (``apply``) runs: the mesh's first
        device."""
        return self.mesh[0]

    def with_mesh(self, mesh) -> "TorchBsrShardedBackend":
        """A copy of this backend pinned to ``mesh`` (the hook ``run_fsi``
        threads an explicit mesh through)."""
        return TorchBsrShardedBackend(block_shape=self.block_shape,
                                      clip=self.clip, mesh=mesh,
                                      dispatch=self.dispatch)

    @property
    def n_devices(self) -> int:
        return len(self.mesh)

    @property
    def state_key(self) -> str:
        return f"{super().state_key}:d{self.n_devices}:{self.dispatch}"

    def _shards(self, a: np.ndarray) -> List[torch.Tensor]:
        """``a [p_pad, ...]`` cut into the mesh's blocks of ``p_pad / D``
        rows, block ``d`` moved to ``mesh[d]``."""
        per = a.shape[0] // self.n_devices
        return [torch.from_numpy(a[d * per:(d + 1) * per]).to(dev)
                for d, dev in enumerate(self.mesh)]

    def fleet_prepare_all(
        self, layer_states: Sequence[Sequence[_TorchBsrLayerState]]
    ) -> List[_TorchBsrShardedFleetState]:
        """Stack each layer's panel once at ``p_pad`` workers on the host,
        then place each device's block on its device (offline, unbilled)."""
        maxima = self._fleet_maxima(layer_states)
        if maxima is None:
            return []
        nbr_max, k_max, n_pad_max = maxima
        D = self.n_devices
        out: List[_TorchBsrShardedFleetState] = []
        for states in layer_states:
            p_pad = -(-len(states) // D) * D
            blocks, cols, counts = map(self._shards, self._stack_layer(
                states, p_pad, nbr_max, k_max))
            out.append(_TorchBsrShardedFleetState(
                blocks=blocks, cols=cols, counts=counts,
                m=[s.m for s in states], n=[s.n for s in states],
                n_pad=n_pad_max, p_pad=p_pad))
        return out

    def _fleet_rows(self, fleet_state: _TorchBsrShardedFleetState, P: int) -> int:
        return fleet_state.p_pad

    def _fleet_launch(self, fleet_state: _TorchBsrShardedFleetState,
                      X: np.ndarray, bias: float) -> np.ndarray:
        """Each device's block of ``X``'s ``p_pad`` rows on its device,
        through the dispatch's kernel; the blocks' outputs concatenated."""
        from repro_torch.kernels.bsr_spmm.ops import (
            bsr_spmm_fleet_fused_sharded,
            bsr_spmm_fleet_sharded,
        )

        Xd = self._shards(X)
        if self.dispatch == "fused":
            ys = bsr_spmm_fleet_fused_sharded(
                fleet_state.blocks, fleet_state.cols, fleet_state.counts, Xd,
                bias=bias, clip=self.clip)
        else:
            ys = bsr_spmm_fleet_sharded(
                fleet_state.blocks, fleet_state.cols, Xd, bias=bias,
                clip=self.clip)
        return np.concatenate([t.cpu().numpy() for t in ys])


# ---------------------------------------------------------------------------
# decode-attention backends (serving per-step hot path)
# ---------------------------------------------------------------------------


def _require_device(name: str, device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{name} runs on a CUDA device by default and none is available; "
            f"pass device='cpu' to run its plain PyTorch version on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    return device


@dataclasses.dataclass(frozen=True)
class KVCacheLayout:
    """Decode KV-cache layout: ``[..., B, KV, S, D]`` with the sequence
    capacity ``S`` padded up to a ``block_k`` multiple at prefill, so the
    per-step decode reads the buffers as they are.  ``block_k`` is the
    padding quantum: 1 for the plain backends, the split-KV table's entry
    for ``torch-splitk`` (the CUDA kernel itself takes any capacity)."""

    block_k: int = 1

    def padded_len(self, max_len: int) -> int:
        """Cache capacity for a requested ``max_len``: the next ``block_k``
        multiple (identity when ``block_k == 1``)."""
        bk = max(1, int(self.block_k))
        return -(-max(int(max_len), 1) // bk) * bk

    def blocks_for(self, max_len: int) -> int:
        """Number of ``block_k``-sized pages a sequence of up to ``max_len``
        tokens occupies: the allocation unit of the paged KV pool
        (``serving/kv_pool.py``); a request holds ``blocks_for(prompt +
        max_new)`` pages for its lifetime and frees them at retirement."""
        return self.padded_len(max_len) // max(1, int(self.block_k))

    def check_capacity(self, seq_cap: int) -> None:
        if seq_cap % max(1, int(self.block_k)):
            raise ValueError(
                f"KV cache capacity {seq_cap} is not a multiple of "
                f"block_k={self.block_k}; pad the cache at prefill with "
                f"KVCacheLayout.padded_len (ServingEngine does this)")


def cache_layout_for(backend, max_len: int) -> KVCacheLayout:
    """The :class:`KVCacheLayout` a backend instance wants for a cache of
    capacity ``max_len`` (identity layout for duck-typed externals)."""
    fn = getattr(backend, "cache_layout", None)
    return fn(max_len) if fn is not None else KVCacheLayout()


class AttentionBackend(Protocol):
    """Single-token decode attention over a preallocated KV cache.

    Caches arrive as ``[B, KV, S, D]`` with ``S`` already padded per
    ``cache_layout(max_len)``.  ``cache_len`` is an int or an int32 tensor
    on the cache's device, so a decode loop never syncs with the host.
    ``q`` may be narrower than the cache (bf16 over the moe family's fp32
    cache): it is widened, and the output rounded to ``q.dtype`` once.
    """

    name: str

    def cache_layout(self, max_len: int) -> KVCacheLayout:
        """Layout (padding rule) this backend needs for capacity ``max_len``."""
        ...

    def decode(self, q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, cache_len: Any) -> torch.Tensor:
        """``q [B, 1, H, D]`` → attention output ``[B, 1, H, D]`` in
        ``q.dtype``."""
        ...

    def decode_partial(self, q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, cache_len: Any
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split-KV form: ``(out [B,1,H,D] normalized partial,
        lse [B,1,H] fp32)`` for an lse-weighted combine."""
        ...

    # Optional, beside ``decode_paged(q, k_cache, v_cache, cache_len)``:
    # ``decode`` over one layer of a ``models.kvcache.PagedKV``, the pool's
    # pages read through the block table (``TorchSplitKAttention``'s
    # kernel).  A backend without it (the plain oracles) gets each layer's
    # pages gathered by the table from ``transformer._decode_attn``.


class DenseRefAttention:
    """``decode_attention_dense``: the whole masked cache in one softmax,
    the parity oracle for the registry."""

    name = "dense-ref"

    @property
    def state_key(self) -> str:
        return self.name

    def cache_layout(self, max_len: int) -> KVCacheLayout:
        return KVCacheLayout(block_k=1)

    def decode(self, q, k_cache, v_cache, cache_len):
        return decode_attention_dense(q, k_cache, v_cache, cache_len)

    def decode_partial(self, q, k_cache, v_cache, cache_len):
        return decode_attention_dense(q, k_cache, v_cache, cache_len,
                                      return_lse=True)


class ChunkedLseAttention:
    """Streaming KV-chunk scan with running (max, sum, acc): bounded
    memory for very long caches; the chunk size is a tile knob that leaves
    the numerics unchanged."""

    name = "chunked-lse"

    def __init__(self, kv_chunk: int = 2048):
        self.kv_chunk = kv_chunk

    @property
    def state_key(self) -> str:
        return f"{self.name}:kc{self.kv_chunk}"

    def cache_layout(self, max_len: int) -> KVCacheLayout:
        return KVCacheLayout(block_k=1)

    def decode(self, q, k_cache, v_cache, cache_len):
        return decode_attention(q, k_cache, v_cache, cache_len=cache_len,
                                kv_chunk=self.kv_chunk).to(q.dtype)

    def decode_partial(self, q, k_cache, v_cache, cache_len):
        return decode_attention(q, k_cache, v_cache, cache_len=cache_len,
                                kv_chunk=self.kv_chunk, return_lse=True)


# (padded cache length upper bound, block_k): the reference's split-KV
# table, kept only as the cache-padding rule so that cache capacities equal
# the reference's.  It sets no tile of the CUDA kernel.
SPLITK_BLOCK_K_TABLE: Tuple[Tuple[Optional[int], int], ...] = (
    (256, 64),
    (1024, 128),
    (4096, 256),
    (None, 512),
)


class TorchSplitKAttention:
    """Split-KV flash decode through the hand-written CUDA kernel of
    ``kernels/decode_attention`` (``ops.decode_mha``).

    The cache arrives as ``[B, KV, S, D]`` with ``S`` padded to the
    ``block_k`` of :data:`SPLITK_BLOCK_K_TABLE` (or the pinned
    ``block_k``); positions at or beyond ``cache_len`` are masked in the
    kernel.  ``device="cuda"`` (the default) raises where no CUDA device is
    present; ``device="cpu"`` is for the CPU tests, where ``decode_mha``
    runs the kernel's plain PyTorch version on CPU tensors.  The kernel is
    chosen by the tensors' device, and nothing falls back from one to the
    other.
    """

    name = "torch-splitk"

    def __init__(self, block_k: Optional[int] = None, device="cuda"):
        self.device = _require_device(self.name, device)
        self.block_k = block_k

    @property
    def state_key(self) -> str:
        return f"{self.name}:bk{self.block_k}:{self.device}"

    def block_k_for(self, seq_cap: int) -> int:
        if self.block_k is not None:
            return self.block_k
        for bound, bk in SPLITK_BLOCK_K_TABLE:
            if bound is None or seq_cap <= bound:
                return bk
        raise AssertionError("unreachable")  # pragma: no cover

    def cache_layout(self, max_len: int) -> KVCacheLayout:
        # The table's bounds are multiples of their own block_k, so
        # padded_len never crosses into a bucket with another block size.
        return KVCacheLayout(block_k=self.block_k_for(max(int(max_len), 1)))

    def decode(self, q, k_cache, v_cache, cache_len):
        out, _ = self.decode_partial(q, k_cache, v_cache, cache_len)
        return out.to(q.dtype)

    def decode_partial(self, q, k_cache, v_cache, cache_len):
        """A ``q`` narrower than the cache (the moe family's bf16 ``q`` over
        its fp32 cache) is widened to the cache's dtype, which is exact, and
        the kernel of that dtype runs; :meth:`decode` rounds its output to
        ``q.dtype`` once, as the reference's kernel writes it."""
        S = k_cache.shape[2]
        self.cache_layout(S).check_capacity(S)  # no silent per-step re-pad
        B, _, H, D = q.shape
        out, lse = decode_mha(q.reshape(B, H, D).to(k_cache.dtype), k_cache,
                              v_cache, cache_len)
        return out[:, None], lse[:, None]

    def decode_paged(self, q, k_cache, v_cache, cache_len):
        """:meth:`decode` over one layer of a ``PagedKV``: the kernel's
        paged form (``ops.decode_mha_paged``) reads the pages through the
        block table, at the split plan of the capacity, so the output is
        :meth:`decode`'s over the gathered copy bit for bit."""
        S = k_cache.capacity
        self.cache_layout(S).check_capacity(S)
        B, _, H, D = q.shape
        pages = k_cache.pages
        out, _ = decode_ops.decode_mha_paged(
            q.reshape(B, H, D).to(pages.dtype), pages, v_cache.pages,
            k_cache.table, cache_len)
        return out[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


_REGISTRY: Dict[str, type] = {
    NumpyCsrBackend.name: NumpyCsrBackend,
    NumpyFastBackend.name: NumpyFastBackend,
    TorchBsrBackend.name: TorchBsrBackend,
    TorchBsrShardedBackend.name: TorchBsrShardedBackend,
}
BACKEND_NAMES = tuple(_REGISTRY)

_ATTENTION_REGISTRY: Dict[str, type] = {
    DenseRefAttention.name: DenseRefAttention,
    ChunkedLseAttention.name: ChunkedLseAttention,
    TorchSplitKAttention.name: TorchSplitKAttention,
}
ATTENTION_BACKEND_NAMES = tuple(_ATTENTION_REGISTRY)

# kind → (registry, default name, label, duck-type method an instance of the
# kind must expose — catches a wrong-kind instance at resolution time)
_KINDS = {
    "compute": (_REGISTRY, "torch-bsr", "compute backend", "apply"),
    "attention": (_ATTENTION_REGISTRY, "torch-splitk", "attention backend",
                  "decode"),
}

_LEGACY = object()  # sentinel: one-argument get_backend(name) = compute


def get_backend(kind, name=_LEGACY):
    """Resolve a backend by ``(kind, name)``.

    ``get_backend("compute", "numpy-fast")`` / ``get_backend("attention",
    "dense-ref")``.  ``name=None`` resolves to the kind's default,
    ``torch-bsr`` and ``torch-splitk``, both on the CUDA device, which raise
    where no CUDA device is present.  Instances pass through unchanged, so
    callers can hand in a pre-configured backend (e.g.
    ``TorchBsrBackend(device="cpu")``).

    The one-argument form ``get_backend(name_or_instance)`` means a compute
    backend.
    """
    if name is _LEGACY:
        kind, name = "compute", kind
    if kind not in _KINDS:
        raise ValueError(
            f"unknown backend kind {kind!r}; options: {tuple(_KINDS)}"
        )
    registry, default, label, duck_method = _KINDS[kind]
    if name is None:
        name = default
    if not isinstance(name, str):
        if not callable(getattr(name, duck_method, None)):
            raise TypeError(
                f"{name!r} is not a {label}: missing .{duck_method}()"
            )
        return name
    try:
        cls = registry[name]
    except KeyError:
        raise ValueError(
            f"unknown {label} {name!r}; options: {tuple(registry)}"
        ) from None
    return cls()


def attention_backend_for(name: Union[str, Any, None],
                          device="cuda") -> Any:
    """The attention backend that serves on ``device``: a name (``None``
    for the default, ``torch-splitk``) resolves with ``torch-splitk`` built
    for ``device``; instances pass through as in :func:`get_backend`."""
    if name is None or name == TorchSplitKAttention.name:
        return TorchSplitKAttention(device=device)
    return get_backend("attention", name)
