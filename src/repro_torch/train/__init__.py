"""repro_torch.train — the training step."""
from .train_step import StepFns, build_train_step, loss_fn

__all__ = ["StepFns", "build_train_step", "loss_fn"]
