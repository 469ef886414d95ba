"""Synthetic MIT/IEEE/Amazon GraphChallenge-style sparse DNNs (paper §VI-A).

The paper evaluates on the Sparse DNN Graph Challenge [Kepner et al., HPEC'19]:
L=120 layers, N ∈ {1024, 4096, 16384, 65536} neurons per layer, 32 nonzeros
per row (RadiX-Net topologies), ReLU with per-N bias and activations clipped
at 32.  The official nets are RadiX-Net mixed-radix butterflies — *structured*
sparsity, which is what hypergraph partitioning exploits (Table III).

We generate equivalent structured nets offline: each layer's rows connect to a
32-wide "digit window" of the column index space (a radix-32 butterfly whose
window position cycles across layers), optionally perturbed with random
rewires to control structure.  ``mode="random"`` gives the unstructured
worst case.

Ground truth comes from the dense oracle (`dense_inference`), mirroring the
Graph Challenge's provided truth files: the benchmark's correctness criterion
is the set of rows with nonzero activation after the last layer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Literal

import numpy as np

from repro_torch.core.sparse import CSRMatrix, random_sparse

__all__ = [
    "GraphChallengeNet",
    "BIAS_BY_NEURONS",
    "make_sparse_dnn",
    "make_inputs",
    "dense_inference",
    "relu_bias_threshold",
    "net_from_arrays",
]

# Paper §VI-A1: biases of -0.30, -0.35, -0.40, -0.45 for N = 1024..65536.
BIAS_BY_NEURONS = {1024: -0.30, 4096: -0.35, 16384: -0.40, 65536: -0.45}
ACTIVATION_CLIP = 32.0
NNZ_PER_ROW = 32
WEIGHT_VALUE = 1.0 / 16.0  # GraphChallenge weights are ±1/16


@dataclasses.dataclass
class GraphChallengeNet:
    neurons: int
    layers: List[CSRMatrix]
    bias: float

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def total_nnz(self) -> int:
        return sum(W.nnz for W in self.layers)

    @property
    def model_bytes(self) -> int:
        # CSR storage: 4B value + 4B col id per nnz (+ indptr, negligible)
        return self.total_nnz * 8


def _butterfly_layer(
    n: int, window_offset: int, rng: np.random.Generator, rewire_frac: float
) -> CSRMatrix:
    """Radix-32 butterfly: row i connects to the 32 columns whose index agrees
    with i outside a 5-bit window starting at ``window_offset``."""
    bits = int(np.log2(n))
    assert 2**bits == n, "GraphChallenge sizes are powers of two"
    w = min(5, bits)
    window_offset = window_offset % max(1, bits - w + 1)
    mask = ((1 << w) - 1) << window_offset
    i = np.arange(n, dtype=np.int64)[:, None]
    t = np.arange(1 << w, dtype=np.int64)[None, :]
    cols = (i & ~mask) | (t << window_offset)
    if rewire_frac > 0:
        flat = cols.reshape(-1)
        n_rewire = int(rewire_frac * flat.size)
        pos = rng.choice(flat.size, size=n_rewire, replace=False)
        flat[pos] = rng.integers(0, n, size=n_rewire)
        cols = flat.reshape(n, 1 << w)
    cols = np.sort(cols, axis=1)
    nnz = cols.shape[1]
    indptr = np.arange(n + 1, dtype=np.int64) * nnz
    # GraphChallenge synthetic DNN weights are uniform +1/16 (positive), the
    # negative bias is what prunes activations.
    data = np.full(n * nnz, WEIGHT_VALUE, dtype=np.float32)
    return CSRMatrix(
        shape=(n, n), indptr=indptr, indices=cols.reshape(-1).astype(np.int32), data=data
    )


def make_sparse_dnn(
    neurons: int,
    n_layers: int = 120,
    seed: int = 0,
    mode: Literal["radix", "random"] = "radix",
    rewire_frac: float = 0.0,
    bias: float | None = None,
) -> GraphChallengeNet:
    rng = np.random.default_rng(seed)
    if bias is None:
        bias = BIAS_BY_NEURONS.get(neurons, -0.30)
    layers: List[CSRMatrix] = []
    for k in range(n_layers):
        if mode == "radix":
            layers.append(_butterfly_layer(neurons, window_offset=k * 3, rng=rng,
                                           rewire_frac=rewire_frac))
        else:
            layers.append(
                random_sparse(neurons, neurons, NNZ_PER_ROW, rng, value_scale=WEIGHT_VALUE)
            )
    return GraphChallengeNet(neurons=neurons, layers=layers, bias=bias)


def net_from_arrays(neurons: int, bias: float, layers) -> GraphChallengeNet:
    """A net from plain numpy arrays, e.g. another package's copy of the same
    weights: ``layers`` is a sequence of ``(shape, indptr, indices, data)``
    tuples, one CSR matrix per layer.  The arrays are copied, so the net
    shares no buffer with its source."""
    return GraphChallengeNet(
        neurons=int(neurons),
        layers=[
            CSRMatrix(shape=(int(shape[0]), int(shape[1])),
                      indptr=np.array(indptr, dtype=np.int64),
                      indices=np.array(indices, dtype=np.int32),
                      data=np.array(data, dtype=np.float32))
            for shape, indptr, indices, data in layers
        ],
        bias=float(bias),
    )


def make_inputs(neurons: int, batch: int, seed: int = 0, density: float = 0.3) -> np.ndarray:
    """Thresholded, flattened MNIST-like inputs: x^0 of shape [neurons, batch].

    The Graph Challenge scales MNIST to N pixels and thresholds to {0,1}.
    We synthesize sparse binary columns at the benchmark's typical density.
    """
    rng = np.random.default_rng(seed + 17)
    x = (rng.random((neurons, batch)) < density).astype(np.float32)
    return x


def relu_bias_threshold(z: np.ndarray, bias: float) -> np.ndarray:
    """The Graph Challenge layer epilogue: y = min(max(z + b, 0), 32)."""
    return np.minimum(np.maximum(z + bias, 0.0), ACTIVATION_CLIP)


def dense_inference(net: GraphChallengeNet, x0: np.ndarray) -> np.ndarray:
    """Oracle: dense matmul reference for the full network."""
    x = x0.astype(np.float32)
    for W in net.layers:
        z = W.matmul_dense_fast(x)
        x = relu_bias_threshold(z, net.bias)
    return x


def category_counts(x_last: np.ndarray) -> np.ndarray:
    """Graph Challenge result: rows with any nonzero activation per sample."""
    return (x_last > 0).astype(np.int64)
