"""Serving: the decode engine (``engine``) and the fixed-slot padding its
batched servers share (``slots``)."""

from .slots import pad_to_slots

_ENGINE = ("Request", "ServeEngine", "kv_cache_specs", "make_serve_step")


def __getattr__(name: str):
    # the engine imports the model package, which reaches the backend, whose
    # PipelineServer imports serve.slots: the engine loads on first use so
    # that importing this package does not close that cycle
    if name in _ENGINE:
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Request", "ServeEngine", "kv_cache_specs", "make_serve_step", "pad_to_slots"]
