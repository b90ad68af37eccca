"""Deterministic, shardable, checkpoint-resumable synthetic token pipeline
(port of ``repro.data.pipeline``).

  * deterministic: batch ``i`` is a pure function of (seed, i) — any host can
    regenerate any batch, which is what makes elastic restart trivial;
  * shardable: each data-parallel host generates only its slice (pass
    ``shard_index``/``shard_count``), matching the paper's placement lesson —
    data is born where it is consumed, never scattered from host 0;
  * resumable: the iterator state is one integer (next step), stored in the
    checkpoint; no file offsets to replay.

The token stream is a stationary Markov chain over the vocab (not uniform
noise) so cross-entropy has learnable structure.  The tokens come from
numpy with the reference's seeds, so every batch is bit for bit the
reference's; :func:`make_train_batch` hands them over as torch tensors on
the caller's device.  The VLM and encoder stub inputs (``patches``,
``frames``) are drawn from a ``torch.Generator`` seeded from
(``extras_seed``, step): the same seed gives the same values, but not
``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 16  # Markov out-degree: lower => more learnable


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig, *, shard_index: int = 0, shard_count: int = 1):
        if cfg.global_batch % shard_count:
            raise ValueError(f"global batch {cfg.global_batch} does not split into "
                             f"{shard_count} shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.local_batch = cfg.global_batch // shard_count
        # Fixed random successor table: token t may be followed only by
        # successors[t, :branching]; deterministic in the seed.
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching), dtype=np.int64
        )

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of step: the whole fleet agrees on batch contents."""
        cfg = self.cfg
        rows = []
        base = step * cfg.global_batch + self.shard_index * self.local_batch
        for r in range(self.local_batch):
            rng = np.random.default_rng((cfg.seed + 1) * 1_000_003 + base + r)
            toks = np.empty(cfg.seq_len + 2, dtype=np.int64)
            toks[0] = rng.integers(cfg.vocab_size)
            choices = rng.integers(0, cfg.branching, size=cfg.seq_len + 1)
            for t in range(1, cfg.seq_len + 2):
                toks[t] = self._succ[toks[t - 1], choices[t - 1]]
            rows.append(toks)
        arr = np.stack(rows).astype(np.int32)
        return {
            "tokens": arr[:, : cfg.seq_len],
            "labels": arr[:, 1 : cfg.seq_len + 1],
            "labels2": arr[:, 2 : cfg.seq_len + 2],
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_train_batch(
    pipe: TokenPipeline,
    state: PipelineState,
    cfg: ModelConfig,
    shape: ShapeConfig | None = None,
    *,
    extras_seed: int = 17,
    device: torch.device | str = "cpu",
) -> tuple[dict[str, torch.Tensor], PipelineState]:
    """Next batch (int32 tokens and labels on ``device``) + advanced state;
    adds stub modality inputs when needed (patches, frames: drawn by a CPU
    generator seeded by the step, then moved, so every device gets the same
    batch)."""
    raw = pipe.batch_at(state.step)
    batch = {"tokens": torch.from_numpy(np.ascontiguousarray(raw["tokens"])).to(device),
             "labels": torch.from_numpy(np.ascontiguousarray(raw["labels"])).to(device)}
    if cfg.mtp_depth:
        batch["labels2"] = torch.from_numpy(np.ascontiguousarray(raw["labels2"])).to(device)
    dt = getattr(torch, cfg.dtype)
    if cfg.n_patches:
        gen = torch.Generator().manual_seed(extras_seed * 1_000_003 + state.step)
        batch["patches"] = torch.randn((pipe.local_batch, cfg.n_patches, cfg.d_model),
                                       generator=gen).to(device, dt)
    if cfg.is_encoder_decoder:
        gen = torch.Generator().manual_seed((extras_seed + 1) * 1_000_003 + state.step)
        batch["frames"] = torch.randn((pipe.local_batch, cfg.encoder_len, cfg.d_model),
                                      generator=gen).to(device, dt)
    return batch, PipelineState(step=state.step + 1)
