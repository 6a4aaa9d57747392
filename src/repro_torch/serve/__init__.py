"""Serving: decode / prefill builders, the continuous-batching engine and
the self-healing join loop."""
from .engine import Request, SelfHealingSession, ServingEngine
from .serve_step import ServeFns, build_decode_step, build_prefill

__all__ = ["Request", "SelfHealingSession", "ServingEngine", "ServeFns",
           "build_decode_step", "build_prefill"]
