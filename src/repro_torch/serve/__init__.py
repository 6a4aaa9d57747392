"""Serving: decode / prefill builders and the continuous-batching engine."""
from .engine import Request, ServingEngine
from .serve_step import ServeFns, build_decode_step, build_prefill

__all__ = ["Request", "ServingEngine", "ServeFns", "build_decode_step",
           "build_prefill"]
