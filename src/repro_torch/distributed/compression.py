"""On-wire gradient compression with error feedback (the reference's).

``Int8Compressor`` quantizes gradients to int8 with one scale a leaf of
the reference's tree before the data-parallel reduction, and keeps the
quantization residual in an error-feedback buffer that is added back the
next step.  A stacked leaf (``blocks/attn/wq`` over the layers) shares one
scale, as it does in the reference.  ``quantize_int8`` keeps the
reference's order of operations (``x / scale``, round half to even, clip),
so ``q`` and the scale are its bits on the CPU.  ``compressed_psum`` is
the reference's int8 all-reduce (its ``shard_map`` building block) over
the port's shard lists (``launch/mesh.py``): one tensor a shard along the
reduced axis, each on its own device, reduced in shard order on the
first shard's device.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from repro_torch.models.param_tree import Path, RefLeaf

__all__ = ["quantize_int8", "dequantize_int8", "Int8Compressor",
           "compressed_psum"]

F32 = torch.float32


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    # a true division by 127 (a host scalar divides by its reciprocal's
    # product on the card)
    return torch.div(torch.clamp(absmax, min=1e-12),
                     torch.tensor(127.0, dtype=F32, device=absmax.device))


def _quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization → (q, scale)."""
    x32 = x.to(F32)
    scale = _scale_of(torch.max(torch.abs(x32)))
    return _quantize(x32, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


class Int8Compressor:
    """Error-feedback int8 compression over the reference's gradient tree
    (a dict from leaf path to :class:`RefLeaf`)."""

    def init(self, params: Mapping[Path, RefLeaf]) -> Dict[Path, RefLeaf]:
        return {k: leaf.map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                  device=p.device))
                for k, leaf in params.items()}

    def compress(self, grads: Mapping[Path, RefLeaf],
                 error: Mapping[Path, RefLeaf]):
        """Returns (the quantized tree: ``{path: (q parts, scale)}``, the new
        error buffers)."""
        quant: Dict[Path, Tuple[List[torch.Tensor], torch.Tensor]] = {}
        new_error: Dict[Path, RefLeaf] = {}
        for key, leaf in grads.items():
            targets = [g.to(F32) + e
                       for g, e in zip(leaf.parts, error[key].parts)]
            scale = _scale_of(torch.max(torch.stack(
                [torch.max(torch.abs(t)) for t in targets])))
            qs = [_quantize(t, scale) for t in targets]
            quant[key] = (qs, scale)
            new_error[key] = RefLeaf(leaf.lead, [
                t - dequantize_int8(q, scale) for t, q in zip(targets, qs)])
        return quant, new_error

    @staticmethod
    def decompress(quant, like: Mapping[Path, RefLeaf]) -> Dict[Path, RefLeaf]:
        """The fp32 gradients back, in ``like``'s structure."""
        out = {}
        for k, leaf in like.items():
            qs, scale = quant[k]
            out[k] = RefLeaf(leaf.lead, [dequantize_int8(q, scale) for q in qs])
        return out

    @staticmethod
    def wire_bytes(grads: Mapping[Path, RefLeaf]) -> Tuple[int, int]:
        """(fp32 bytes, int8 bytes) the data-parallel reduction would move:
        4 bytes an element, or 1 and a 4-byte scale a leaf."""
        sizes = [sum(p.numel() for p in leaf.parts) for leaf in grads.values()]
        return sum(4 * n for n in sizes), sum(n + 4 for n in sizes)


def compressed_psum(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The int8-quantized all-reduce of same-shaped ``shards``: each
    shard's scale is ``max(|x|, 1e-12) / 127``, the shared scale their
    maximum (the reference's ``pmax``), each shard is quantized as
    ``clip(round(x / scale), -127, 127)`` in int32, the quantized shards
    are summed in int32 in shard order on the first shard's device (the
    reference's ``psum``), and the sum comes back in fp32 times the scale,
    on that device.  Every step but the division by the scale is exact or
    elementwise in one rounding, so the result is the reference's bit for
    bit wherever the division is IEEE's (the CPU, and the card, where the
    scale stays a device tensor)."""
    if not shards:
        raise ValueError("compressed_psum needs at least one shard")
    shapes = {tuple(s.shape) for s in shards}
    if len(shapes) != 1:
        raise ValueError(f"compressed_psum's shards differ in shape: {shapes}")
    home = shards[0].device
    x32 = [s.to(F32) for s in shards]
    scale = torch.max(torch.stack([
        _scale_of(torch.max(torch.abs(x))).to(home) for x in x32]))
    total = torch.zeros(x32[0].shape, dtype=torch.int32, device=home)
    for x in x32:
        q = torch.div(x, scale.to(x.device)).round_().clamp_(-127, 127)
        total += q.to(torch.int32).to(home)
    return total.to(F32) * scale
