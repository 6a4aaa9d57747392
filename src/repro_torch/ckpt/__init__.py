"""repro_torch.ckpt — checkpoints in the reference package's format."""
from .checkpoint import Checkpointer

__all__ = ["Checkpointer"]
