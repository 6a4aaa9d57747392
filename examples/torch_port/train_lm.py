"""Train a small LM end to end with the PyTorch + CUDA port (data -> step
-> checkpoint -> resume).

Uses the port's driver (`repro_torch.launch.train`) on a reduced config:
the ~6M-parameter qwen2-style model, a few hundred steps, loss must
descend.  `--fail-at-step` demonstrates the elastic-restart path.  On the
card the train step is a CUDA graph: its first call runs eagerly, its
second is captured, and every later one replays it.

Run:  PYTHONPATH=src python examples/torch_port/train_lm.py [--steps 200]
      [--device cuda|cpu]   (default cuda; without a card it raises)
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main

ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "200",
        "--batch", "8", "--seq", "64", "--lr", "1e-3",
        "--ckpt-every", "100",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                   "repro_torch_example_ckpt"),
        "--log-every", "20"]


def main(argv: list[str] | None = None) -> None:
    """The driver with the example's arguments, then `argv` (the command
    line's by default), whose flags override them."""
    train_main(ARGV + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
