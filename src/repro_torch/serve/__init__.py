"""Serving: decode / prefill builders, the continuous-batching engine, the
self-healing join loop and the multi-tenant join engine."""
from .engine import Request, SelfHealingSession, ServingEngine
from .join_engine import ExecutableCache, JoinRequest, JoinServingEngine
from .serve_step import ServeFns, build_decode_step, build_prefill

__all__ = ["Request", "SelfHealingSession", "ServingEngine",
           "ExecutableCache", "JoinRequest", "JoinServingEngine", "ServeFns",
           "build_decode_step", "build_prefill"]
