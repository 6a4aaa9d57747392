"""Serving: decode / prefill builders, the continuous-batching engine, the
self-healing join loop and the multi-tenant join engine.

Each name is imported at its first use, so that a process that serves the
join alone (a spawned rank of the join's mesh) does not import the LM's
modules, nor torch.distributed.tensor, which they need."""
import importlib

_MODULES = {
    "Request": "engine", "SelfHealingSession": "engine",
    "ServingEngine": "engine",
    "ExecutableCache": "join_engine", "JoinRequest": "join_engine",
    "JoinServingEngine": "join_engine",
    "ServeFns": "serve_step", "build_decode_step": "serve_step",
    "build_prefill": "serve_step", "cache_placements": "serve_step",
}

__all__ = list(_MODULES)


def __getattr__(name: str):
    if name in _MODULES:
        return getattr(importlib.import_module(f".{_MODULES[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
