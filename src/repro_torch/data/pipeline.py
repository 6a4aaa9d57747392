"""Tokenized LM data pipeline (a copy of the reference package's, numpy only).

Deterministic, restartable (step -> batch is a pure function of (seed, step)),
and shardable: each data-parallel rank materializes only its slice.
Batches stay numpy, array for array the reference's; the trainer moves
them to its device.

Synthetic token streams stand in for a real tokenizer; the interface (`global_batch`, `__call__(step) -> {tokens, labels}`) is what a real
loader would implement.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1   # natural-language token frequency is zipfian


class TokenPipeline:
    """step -> next-token-prediction batch, deterministic and restartable."""

    def __init__(self, cfg: PipelineConfig, dp_rank: int = 0, dp_size: int = 1):
        if cfg.global_batch % dp_size:
            raise ValueError(f"global_batch {cfg.global_batch} % dp_size {dp_size} != 0")
        self.cfg = cfg
        self.dp_rank, self.dp_size = dp_rank, dp_size
        self.local_batch = cfg.global_batch // dp_size
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._p = p / p.sum()

    def __call__(self, step: int) -> dict[str, np.ndarray]:
        """This rank's shard of the step's batch.

        The GLOBAL batch is a pure function of (seed, step) — independent of
        dp_size — so elastic re-meshing (ft/elastic.py changes the DP degree)
        never changes the data stream; ranks just slice different rows.
        """
        g = self.global_batch_at(step)
        lo = self.dp_rank * self.local_batch
        return {k: v[lo:lo + self.local_batch] for k, v in g.items()}

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, step))
        toks = rng.choice(
            self.cfg.vocab_size,
            size=(self.cfg.global_batch, self.cfg.seq_len + 1),
            p=self._p).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
