"""Batched serving engine: prefill + greedy decode loop.

Prompts are prefilled once, then decoded step by step with the family's
cache (the KV cache of the dense and vlm families, the fp32 KV stacks of
the moe family, the conv tails and SSM state of the ssm family, both of
the hybrid's, the self- and cross-attention KV of the encdec family), as
in the reference's device engine.  ``extra`` carries the stub frontends'
embeddings: ``{"extra_embeds": [B, F, d]}`` for vlm, ``{"frames": [B,
S_src, d]}`` for encdec.  The engine runs on
a CUDA card unless constructed with ``device="cpu"``, and everything it
launches runs on that device: the attention backend defaults to
``torch-splitk``, the hand-written split-KV kernel, and the generated
tokens stay on the device until the loop ends.  ``generate_stream`` serves
a stream of ragged requests with continuous batching
(``serving/scheduler.py``), its decode step captured in a CUDA graph on the
card.  ``engine="fabric"`` serves over the serverless pipeline instead
(``faas/lm_pipeline.py``): the layer stack splits into stages whose
activations travel the queue or object fabric, on the same device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import (
    KVCacheLayout,
    attention_backend_for,
    cache_layout_for,
)
from repro_torch.models.registry import get_model

__all__ = ["GenerationResult", "ServingEngine", "extra_tensors"]


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # [B, max_new]
    prefill_logits: np.ndarray   # [B, vocab]: the last step's logits
    steps: int
    # Set by the fabric engine: the full LmPipelineResult (billing stats,
    # dual-clock makespans, wire volumes).  None on the device path.
    fabric: Optional[Any] = None


def extra_tensors(extra: Optional[Dict[str, Any]], device) -> Dict[str, Any]:
    """``extra``'s arrays as tensors on ``device`` (numpy arrays through
    fp32, which holds bf16 and fp32 exactly; tensors as they are)."""
    out = {}
    for key, a in (extra or {}).items():
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a, dtype=np.float32))
        out[key] = a.to(device)
    return out


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Optional[nn.Module] = None,
                 seed: int = 0, attn_backend=None, max_len_hint: int = 0,
                 engine: str = "device", device="cuda", pipeline_P: int = 2,
                 pipeline_channel: str = "queue"):
        """``attn_backend``: decode-attention backend name or instance
        (``repro_torch.core.backends``).  ``None`` is the router's pick for
        the card, built for ``device``: ``torch-splitk`` (its plain version
        on the CPU), or the unused oracle for an attention-free family;
        ``"auto"`` asks the router for a
        :class:`repro_torch.serving.router.DecodePlan` for ``device``'s
        type and ``max_len_hint``.

        ``params``: the family's module, a
        :class:`repro_torch.models.transformer.Transformer`, a
        :class:`repro_torch.models.moe.Moe`, a
        :class:`repro_torch.models.mamba2.Mamba2`, a
        :class:`repro_torch.models.hybrid.Hybrid` or a
        :class:`repro_torch.models.encdec.EncDec` (see each module's
        ``params_from_arrays``); ``None`` draws random bf16 weights on
        ``device`` from a ``torch.Generator`` seeded with ``seed``.

        ``engine="fabric"`` serves over the serverless pipeline instead of
        on the device alone: the layer stack splits into ``pipeline_P``
        stages whose activations travel the ``pipeline_channel`` fabric
        (:func:`repro_torch.faas.lm_pipeline.run_lm_pipeline`), every stage
        computing on ``device``; results carry the billing and clock
        telemetry in ``GenerationResult.fabric``.

        On ``"cuda"`` the matmuls accumulate in full fp32 as the reference
        does: the engine switches TF32 and reduced-precision bf16
        reductions off (``torch.backends.cuda.matmul.allow_tf32`` and
        ``allow_bf16_reduced_precision_reduction``)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine runs on a CUDA device by default and none is "
                "available; pass device='cpu' to serve on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"ServingEngine runs on cuda or cpu, not {device!r}")
        if engine not in ("device", "fabric"):
            raise ValueError(f"unknown engine {engine!r}")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.cfg = cfg
        self.engine = engine
        self.pipeline_P = pipeline_P
        self.pipeline_channel = pipeline_channel
        self._stage_executors: Optional[list] = None
        if attn_backend in (None, "auto"):
            from repro_torch.serving.router import route_attention_backend

            auto = attn_backend == "auto"
            attn_backend = route_attention_backend(
                cfg, max_len=(max_len_hint or None) if auto else None,
                platform=self.device.type if auto else "cuda")
        self.attn_backend = attention_backend_for(attn_backend, self.device)
        self.model = get_model(cfg, attn_backend=self.attn_backend)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self.params = params

    def cache_layout(self, max_len: int) -> KVCacheLayout:
        """The layout the engine's caches use for a given capacity: prefill
        allocates ``[L, B, KV, padded_len(max_len), D]`` buffers with it.
        An ssm engine's cache has no sequence axis; it answers with its
        unused backend's layout, as the reference does."""
        return cache_layout_for(self.attn_backend, max_len)

    def generate(
        self,
        prompts: np.ndarray,            # [B, S_prompt] int32
        max_new_tokens: int = 8,
        extra: Optional[Dict[str, np.ndarray]] = None,
        max_len: Optional[int] = None,
    ) -> GenerationResult:
        """Greedy generation.  ``max_len`` overrides the cache capacity
        (default: exactly what the batch needs).  ``extra``: the frontend's
        embeddings (module docstring), numpy arrays or tensors, moved to
        the engine's device."""
        B, S = prompts.shape
        if self.engine == "fabric":
            return self._generate_fabric(prompts, max_new_tokens, extra)
        if max_len is None:
            max_len = S + max_new_tokens + (self.cfg.frontend_tokens or 0)
        batch: Dict[str, Any] = {
            "tokens": torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                      device=self.device),
            **extra_tensors(extra, self.device)}
        logits, cache = self.model.prefill(self.params, batch, max_len)
        out_tokens = []
        token = logits[:, -1:].argmax(dim=-1)
        for _ in range(max_new_tokens):
            out_tokens.append(token)
            logits, cache = self.model.decode_step(self.params, token, cache)
            token = logits[:, -1:].argmax(dim=-1)
        tokens = (torch.cat(out_tokens, dim=1) if out_tokens
                  else torch.zeros((B, 0), dtype=torch.int64))
        return GenerationResult(
            tokens=tokens.cpu().numpy().astype(np.int32),
            prefill_logits=logits[:, 0].cpu().numpy(),
            steps=max_new_tokens,
        )

    def generate_stream(
        self,
        requests,                        # Sequence[scheduler.Request]
        num_slots: int = 4,
        max_request_len: Optional[int] = None,
        mesh=None,
        axis_name: str = "seq",
    ):
        """Serve a mixed-length request stream with continuous batching.

        Requests are admitted into ``num_slots`` fixed decode slots as they
        arrive and retired the step their token budget completes; KV lives
        in a block-granular paged pool (``serving/kv_pool.py``), so slots
        are reused without defragmenting mid-decode.  Returns a list of
        :class:`repro_torch.serving.scheduler.RequestResult`, in the order
        the requests finished: each bit for bit what the same request
        served alone through a scheduler of this width and capacity gives,
        and, against :meth:`generate` at ``max_len=slot_capacity``, the
        same tokens with logits within 1e-4.

        ``max_request_len`` bounds prompt + new tokens over the stream
        (default: measured from ``requests``).  On the card the decode step
        runs from a CUDA graph (:class:`RequestScheduler`).  ``mesh`` (a
        :class:`repro_torch.launch.mesh.Mesh`) switches the decode step to
        the sequence-sharded one over its devices along ``axis_name``: the
        slot capacity must then split into that many whole ``block_k``
        blocks (the scheduler raises otherwise).  At one shard the stream
        is bit for bit the unsharded one; at more, its tokens are the same
        and its logits within 2e-2.

        The fabric engine has no mid-batch admission point (stage workers
        hold per-batch KV), so it serves each request alone through the
        pipeline, in arrival order, behind the same API.
        """
        from repro_torch.serving.scheduler import RequestScheduler

        requests = list(requests)
        if self.engine == "fabric":
            return self._stream_fabric(requests)
        if max_request_len is None:
            max_request_len = max(
                (np.asarray(r.prompt).reshape(-1).shape[0]
                 + r.max_new_tokens + (self.cfg.frontend_tokens or 0))
                for r in requests)
        # Sized like route_serving_plan's policy, but from the engine's own
        # backend layout (the plan re-routes the backend; an engine built
        # with one must not switch).
        layout = self.cache_layout(max_request_len)
        sched = RequestScheduler(
            self.model, self.params, num_slots=num_slots,
            slot_capacity=layout.padded_len(max_request_len), layout=layout,
            device=self.device, mesh=mesh, axis_name=axis_name)
        return sched.run(requests)

    def _stream_fabric(self, requests):
        from repro_torch.serving.scheduler import RequestResult

        results = []
        for step, req in enumerate(sorted(requests,
                                          key=lambda r: (r.arrival, r.rid))):
            prompt = np.asarray(req.prompt, np.int32).reshape(1, -1)
            res = self._generate_fabric(prompt, req.max_new_tokens, req.extra)
            results.append(RequestResult(
                rid=req.rid, tokens=res.tokens[0],
                final_logits=res.prefill_logits[0],
                prompt_len=prompt.shape[1],
                admitted_step=step, finished_step=step))
        return results

    def _generate_fabric(self, prompts: np.ndarray, max_new_tokens: int,
                         extra: Optional[Dict[str, Any]]) -> GenerationResult:
        """The pipeline's generation.  Only the vlm family stages, and its
        ``extra`` is ``{"extra_embeds": ...}``, whose array goes to the
        embedding stage (the reference's engine hands the pipeline the
        dict, which its stage prefill cannot take)."""
        # Imported here: the pipeline pulls in the FaaS stack, which the
        # device path does not need.
        from repro_torch.faas.lm_pipeline import (
            build_stage_executors,
            run_lm_pipeline,
        )

        if self._stage_executors is None:
            self._stage_executors = build_stage_executors(
                self.cfg, self.params, self.pipeline_P,
                attn_backend=self.attn_backend)
        res = run_lm_pipeline(
            self.cfg, prompts, self.params,
            max_new_tokens=max_new_tokens, P=self.pipeline_P,
            channel=self.pipeline_channel, attn_backend=self.attn_backend,
            extra=(extra or {}).get("extra_embeds"),
            executors=self._stage_executors,
        )
        return GenerationResult(tokens=res.tokens, prefill_logits=res.logits,
                                steps=max_new_tokens, fabric=res)
