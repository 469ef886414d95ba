"""Pluggable compute backends for the FSI per-layer SpMM.

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

Backends only change how the arithmetic is executed — FLOP charging, message
accounting and memory high-water marks are computed by the caller from the
CSR shard itself, so billed cost is identical across backends by
construction (asserted in ``tests/test_torch_fsi.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sparse import CSRMatrix, bsr_from_csr
from repro_torch.data.graphchallenge import ACTIVATION_CLIP, relu_bias_threshold

__all__ = [
    "ComputeBackend",
    "NumpyCsrBackend",
    "NumpyFastBackend",
    "TorchBsrBackend",
    "BACKEND_NAMES",
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
        from repro_torch.kernels.bsr_spmm.ops import bsr_spmm_fleet

        P = len(xs)
        batch = xs[0].shape[1]
        X = np.zeros((P, fleet_state.n_pad, batch), dtype=np.float32)
        for i, x in enumerate(xs):
            X[i, : x.shape[0]] = x
        y = bsr_spmm_fleet(
            fleet_state.blocks, fleet_state.cols, fleet_state.counts,
            self._to_device(X), bias=float(bias), clip=self.clip,
        ).cpu().numpy()
        return [y[i, : fleet_state.m[i]] for i in range(P)]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


_REGISTRY: Dict[str, type] = {
    NumpyCsrBackend.name: NumpyCsrBackend,
    NumpyFastBackend.name: NumpyFastBackend,
    TorchBsrBackend.name: TorchBsrBackend,
}
BACKEND_NAMES = tuple(_REGISTRY)

# kind → (registry, default name, label, duck-type method an instance of the
# kind must expose — catches a wrong-kind instance at resolution time)
_KINDS = {
    "compute": (_REGISTRY, "torch-bsr", "compute backend", "apply"),
}

_LEGACY = object()  # sentinel: one-argument get_backend(name) = compute


def get_backend(kind, name=_LEGACY):
    """Resolve a backend by ``(kind, name)``.

    ``get_backend("compute", "numpy-fast")``.  ``name=None`` resolves to the
    kind's default, ``torch-bsr`` on the CUDA device, which raises where no
    CUDA device is present.  Instances pass through unchanged, so callers can
    hand in a pre-configured backend (e.g. ``TorchBsrBackend(device="cpu")``).

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
