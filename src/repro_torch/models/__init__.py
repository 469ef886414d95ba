"""Model zoo in PyTorch: parameters in ``nn.Module``s, math in plain
tensor functions, mirroring ``repro.models`` (dense family so far).

A family exposes ``init``, ``forward``, ``prefill`` and ``decode_step``;
``registry.get_model(cfg)`` binds them to a config.
"""
