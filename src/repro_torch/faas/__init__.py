"""Fully-serverless execution substrate (simulated AWS data plane).

Every byte that moves between simulated Lambda workers really moves —
serialized, zlib-compressed, size-capped and billed exactly as SNS/SQS/S3
would — so the cost model validation and the Queue-vs-Object trade-off are
measured, not asserted.

The simulator re-exports are lazy (PEP 562): ``repro_torch.faas.simulator`` imports
``repro_torch.core.fsi``, which imports fabric submodules from this package — an
eager import here would make ``import repro_torch.core.fsi`` circular.
"""

_SIMULATOR_EXPORTS = ("LatencyModel", "run_fsi", "FsiRunResult",
                      "FaultPlan", "FleetFailure")

__all__ = list(_SIMULATOR_EXPORTS)


def __getattr__(name):
    if name in _SIMULATOR_EXPORTS:
        from repro_torch.faas import simulator

        return getattr(simulator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
