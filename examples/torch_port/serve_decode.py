"""Batched serving demo of the PyTorch + CUDA port: prompts fed token by
token through the decode step, then greedy decode against the KV cache
(the decode_32k cell's step function at toy scale).  On the card the step
is a CUDA graph: its first call runs eagerly, its second is captured, and
every later one replays it.

Run:  PYTHONPATH=src python examples/torch_port/serve_decode.py
      [--device cuda|cpu]   (default cuda; without a card it raises)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.executor import resolve_device
from repro_torch.models import api
from repro_torch.serve import build_decode_step

B, MAX_SEQ, PROMPT, GEN = 8, 128, 16, 32


def main(device: str = "cuda", model=None, prompts: np.ndarray | None = None
         ) -> tuple[np.ndarray, np.ndarray]:
    """Feed `prompts` ((B, PROMPT) int32; seeded ones by default) through
    the decode step, then decode GEN tokens greedily; `model` defaults to
    the reduced qwen2-0.5b with weights from a seeded generator on
    `device`.  Returns (prompts, the GEN tokens decoded after the first
    (B, GEN)), as the JAX example prints them."""
    cfg = ARCHS["qwen2-0.5b"].reduced()
    dev = resolve_device(device)
    if model is None:
        model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    if prompts is None:
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    fns = build_decode_step(cfg, B, MAX_SEQ, device=dev)
    cache = api.init_cache(cfg, B, MAX_SEQ, device=dev)

    # "Prefill" the prompts token by token (toy; build_prefill is the fused
    # prompt pass).
    t0 = time.time()
    for t in range(PROMPT):
        pos = torch.full((B,), t, dtype=torch.int32)
        nxt, cache = fns.decode(model, cache,
                                torch.from_numpy(prompts[:, t:t + 1]), pos)
    print(f"prefilled {B}x{PROMPT} tokens in {time.time() - t0:.2f}s")

    # Greedy decode.
    out = []
    t0 = time.time()
    for t in range(PROMPT, PROMPT + GEN):
        pos = torch.full((B,), t, dtype=torch.int32)
        nxt, cache = fns.decode(model, cache, nxt[:, None], pos)
        out.append(nxt)
    gen = torch.stack(out, dim=1).cpu().numpy()
    dt = time.time() - t0
    print(f"generated {B}x{GEN} tokens in {dt:.2f}s ({B * GEN / dt:.0f} "
          f"tok/s on {device}); decode calls: {fns.eager_calls} eager, "
          f"{fns.captures} captured, {fns.replays} replayed")
    print("first sequence:", gen[0].tolist())
    return prompts, gen


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
