"""repro_torch.optim — AdamW (+8-bit states), schedules, gradient
compression."""
from . import adamw, grad_compress, schedule
from .adamw import AdamWConfig

__all__ = ["adamw", "grad_compress", "schedule", "AdamWConfig"]
