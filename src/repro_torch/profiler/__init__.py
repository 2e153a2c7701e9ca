"""Operator-, kernel- and iteration-level latency profilers.

The port of ``repro/profiler``.  Submodules are imported lazily (PEP 562)
so trace-artifact tooling — e.g. ``python -m repro_torch.profiler profile
--device tpu-v6e`` generating a *synthetic* trace — never pays the engine
import; only the measured paths (``runtime_trace``, ``OperatorProfiler``
in measured mode, the kernel sweep) do.
"""
_LAZY = {
    # engine-free
    "model_spec_from_arch": "repro_torch.profiler.arch_spec",
    "get_hw": "repro_torch.hw.specs",
    "register_hw": "repro_torch.hw.specs",
    "measured_cpu_spec": "repro_torch.hw.specs",
    # measured profilers (import torch and the engine)
    "OperatorProfiler": "repro_torch.profiler.operator_profiler",
    "ProfilerConfig": "repro_torch.profiler.operator_profiler",
    "profile_arch": "repro_torch.profiler.operator_profiler",
    "runtime_trace": "repro_torch.profiler.runtime_profiler",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
