"""Published peaks of the cards the benchmark knows, frozen here.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bf16 and fp16, 495 in TF32, 67 in fp32
outside the tensor cores, 1,979 in fp8; 80 GB of HBM3 at 3.35 TB/s.  A card
set below 700 W runs slower under load; the run reports the limit beside
every share of a peak.
"""

from __future__ import annotations

from typing import Dict, Optional

H100_SXM: Dict[str, float] = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "fp8_flops": 1979e12,
    "hbm_bytes_per_s": 3.35e12,
    "memory_bytes": 80e9,
}

# substring of torch.cuda.get_device_name() -> peaks
_CARDS = (("H100", H100_SXM),)


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    """The peaks of the named card, or None for a card not in the table
    (a share of its peak is then not reported)."""
    for key, peaks in _CARDS:
        if key in device_name:
            return peaks
    return None
