"""The worker "mesh" of the sharded fleet backend.

The reference lays the simulated workers over a 1-D ``(worker,)`` JAX
device mesh.  The port's mesh is a plain list of ``torch.device``\\ s, one
per shard of the worker axis: shard ``d`` of a ``p_pad``-worker panel (rows
``d * p_pad / D`` up to the next shard) lives and runs on ``mesh[d]``.  A
list may name one device more than once (``[cuda:0] * 3`` gives D = 3 on
one card) or name the CPU, where the kernels' plain versions run.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["make_worker_mesh"]


def make_worker_mesh(n_devices: Optional[int] = None,
                     device: str = "cuda") -> List[torch.device]:
    """The worker mesh over ``device``'s kind.

    ``device="cuda"`` (the default): the first ``n_devices`` visible CUDA
    devices, every one of them when ``n_devices`` is ``None``; it raises
    where none is visible, or fewer than ``n_devices``.  ``device="cpu"``:
    ``n_devices`` (default 1) entries of the CPU, as the tests use it.
    """
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"a worker mesh is over cuda or cpu, not {device!r}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible == 0:
        raise RuntimeError(
            "make_worker_mesh runs over CUDA devices by default and none is "
            "available; pass device='cpu' for a mesh of the CPU")
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise ValueError(f"{n} CUDA devices asked for, {visible} visible; "
                         f"repeat a device in a list for more shards")
    return [torch.device("cuda", i) for i in range(n)]
