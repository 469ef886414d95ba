"""Config system: architectures × input shapes.

``ModelConfig`` fully describes an architecture (public-literature configs —
sources cited in each ``configs/<id>.py``).  ``ShapeConfig`` describes the
assigned input-shape set.  ``reduced()`` derives the CPU smoke-test version of
any config (same family/topology, tiny dims).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Literal, Optional, Tuple

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "get_config", "get_shape",
    "list_archs", "REGISTRY",
]

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    # each expert takes at most ceil(T·k/E)·factor of a token group's T
    # tokens, the rest drop; None: no capacity, no token ever drops
    moe_capacity_factor: Optional[float] = 1.25
    first_dense_layers: int = 0       # deepseek-moe keeps layer 0 dense
    # True: the top-k weights are a softmax over the k chosen logits (the
    # reference's); False: a softmax over all E, the top k used as they
    # are (HF ``norm_topk_prob: false``, deepseek-moe-16b as published)
    moe_norm_topk_prob: bool = True
    moe_cache_dtype: str = "float32"  # the moe decode cache's dtype
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0
    # --- encoder-decoder (seamless) ---
    n_encoder_layers: int = 0
    # --- modality frontend stub (vlm/audio) ---
    frontend_tokens: int = 0          # embeddings prepended / fed to encoder
    # --- details ---
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    qkv_bias: bool = False            # qwen-style
    tie_embeddings: bool = False
    act: str = "swiglu"
    # TP divisibility: pad head count at init (extra heads are dead weight
    # so the function class is unchanged; analytic param_count uses the true
    # head count — see DESIGN.md §6)
    pad_heads_to: int = 0
    # --- training ---
    optimizer: str = "adamw"          # "adafactor" for the 1T MoE
    lr_schedule: str = "cosine"       # "wsd" for minicpm
    remat: bool = True
    # --- notes / provenance ---
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def eff_heads(self) -> int:
        """Head count actually instantiated (incl. TP padding)."""
        return self.pad_heads_to or self.n_heads

    @property
    def eff_kv_heads(self) -> int:
        if self.pad_heads_to and self.n_kv_heads == self.n_heads:
            return self.pad_heads_to
        return self.n_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def padded_vocab(self, multiple: int = 256) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic archs (ssm / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameters (embedding + blocks), analytic."""
        V, D = self.padded_vocab(), self.d_model
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_layer = self._block_params()
        total = emb + self.n_layers * per_layer + D  # final norm
        if self.family == "encdec":
            total += self.n_encoder_layers * self._encoder_block_params() + D
        if self.family == "hybrid" and self.shared_attn_every:
            total += self._shared_block_params()
        return int(total)

    def active_param_count(self) -> int:
        """Active per-token parameters (MoE: shared + top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        V, D = self.padded_vocab(), self.d_model
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        act_ffn = 3 * D * self.moe_d_ff * (
            self.experts_per_token + self.n_shared_experts
        ) + D * self.n_experts
        dense_ffn = 3 * D * self.d_ff if self.d_ff else 0
        n_moe = self.n_layers - self.first_dense_layers
        total = emb + n_moe * (attn + act_ffn + 2 * D)
        total += self.first_dense_layers * (attn + (dense_ffn or act_ffn) + 2 * D)
        return int(total)

    # -- analytic per-block parameter counts --------------------------------
    def _attn_params(self) -> int:
        D = self.d_model
        return D * self.attn_dim + 2 * D * self.kv_dim + self.attn_dim * D

    def _dense_ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff

    def _moe_ffn_params(self) -> int:
        D = self.d_model
        return (
            3 * D * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
            + D * self.n_experts  # router
        )

    def _mamba_block_params(self) -> int:
        D, DI = self.d_model, self.d_inner
        H, N, G = self.ssm_heads, self.ssm_state, self.ssm_groups
        in_proj = D * (2 * DI + 2 * G * N + H)   # x, z, B, C, dt
        conv = (DI + 2 * G * N) * self.conv_kernel
        out = DI * D
        return in_proj + conv + out + 2 * H + D  # A, D params + norm

    def _block_params(self) -> int:
        D = self.d_model
        if self.family in ("dense", "vlm"):
            return self._attn_params() + self._dense_ffn_params() + 2 * D
        if self.family == "moe":
            return self._attn_params() + self._moe_ffn_params() + 2 * D
        if self.family in ("ssm",):
            return self._mamba_block_params()
        if self.family == "hybrid":
            return self._mamba_block_params()
        if self.family == "encdec":
            # decoder block: self-attn + cross-attn + ffn
            return 2 * self._attn_params() + self._dense_ffn_params() + 3 * D
        raise ValueError(self.family)

    def _encoder_block_params(self) -> int:
        return self._attn_params() + self._dense_ffn_params() + 2 * self.d_model

    def _shared_block_params(self) -> int:
        # zamba2 shared attention block consumes concat(h, emb) → 2D input
        D = self.d_model
        qkv = (2 * D) * self.attn_dim + 2 * (2 * D) * self.kv_dim + self.attn_dim * D
        ffn = 3 * D * self.d_ff
        return qkv + ffn + 4 * D

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test twin: same family & topology, tiny dims."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 7),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            # d_inner = ssm_expand·128 must equal ssm_heads·ssm_head_dim
            ssm_heads=(self.ssm_expand * 128) // 32 if self.ssm_heads else 0,
            ssm_head_dim=32 if self.ssm_heads else 64,
            ssm_chunk=32,
            shared_attn_every=3 if self.shared_attn_every else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            frontend_tokens=min(self.frontend_tokens, 8),
            first_dense_layers=min(self.first_dense_layers, 1),
            pad_heads_to=0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# The architectures the port has, by module.
_ARCH_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "llama3.2-1b": "llama3_2_1b",
    "minicpm-2b": "minicpm_2b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "mamba2-370m": "mamba2_370m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "zamba2-7b": "zamba2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-2b": "internvl2_2b",
    "sparse-dnn-graphchallenge": "sparse_dnn_graphchallenge",
}

REGISTRY = dict(_ARCH_MODULES)


def list_archs() -> Tuple[str, ...]:
    """The language models: every architecture but the sparse DNN."""
    return tuple(k for k in _ARCH_MODULES if k != "sparse-dnn-graphchallenge")


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
