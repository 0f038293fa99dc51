"""Deterministic synthetic-token data pipeline with restart semantics (the
port's copy of repro.data.pipeline: numpy only, so the port yields the
reference's tokens, bit for bit, for the same (seed, step)).

A real deployment would stream from a tokenized corpus; here the pipeline is
a seeded generator so that (a) training runs are reproducible, (b) restart
from a checkpoint resumes the exact stream position (skip-restore is O(1):
the batch for step k is a pure function of (seed, k)), and (c) every host in
a multi-host launch can produce exactly its own shard of the global batch
without coordination (shard-aware addressing).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core.config import ArchConfig, ShapeConfig


@dataclass
class PipelineConfig:
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


class SyntheticTokens:
    """Batch for step k = f(seed, k).  Mildly structured (zipf-ish) tokens so
    CE losses are non-degenerate."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig,
                 cfg: PipelineConfig = PipelineConfig()):
        if arch.family in ("audio", "vlm"):
            raise NotImplementedError(
                f"{arch.name}: the {arch.family} batches (frame / patch "
                "embeddings) join with the whisper and qwen2-vl slices")
        self.arch, self.shape, self.cfg = arch, shape, cfg
        assert shape.global_batch % cfg.host_count == 0
        self.local_batch = shape.global_batch // cfg.host_count

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_index]))
        b, l = self.local_batch, self.shape.seq_len
        v = self.arch.vocab_size
        # zipf-ish marginal over a capped alphabet
        alpha = rng.zipf(1.3, size=(b, l + 1))
        tokens = (alpha % v).astype(np.int32)
        return {"tokens": tokens[:, :l], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
