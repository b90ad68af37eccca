"""Batched LM serving engine: prefill + decode with greedy/temperature
sampling (port of ``repro.serve.engine``).

Static-batch engine: one prefill, then one decode step per new token.  It
runs eagerly (the reference's ``jax.jit`` has no counterpart here).  The
prefill attention goes through the flash kernel on the card
(``repro_torch/csrc/flash_attention.cu``), once per layer; decode attention
is plain PyTorch.  Sampling draws from an explicit seeded
``torch.Generator``: the same seed gives the same tokens, but not
``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.su3.plan import resolve_device
from repro_torch.models import registry


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0
    cache_dtype: str = "float32"  # the reference's default


class ServeEngine:
    """Serve ``params`` (the port's model, see ``registry.get(cfg).init``)
    on ``device``: None means CUDA and raises without it; ``"cpu"`` runs the
    plain versions.  The parameters are moved to the device.

    ``last_timings`` holds the last :meth:`generate`'s phases in seconds:
    ``prefill_s`` and ``decode_s`` (between CUDA events on the card, host
    clock on the CPU) and ``decode_steps``.
    """

    def __init__(self, cfg: ModelConfig, params: torch.nn.Module, scfg: ServeConfig,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.scfg = scfg
        self.api = registry.get(cfg)
        self.last_timings: dict[str, float] = {}

    def init_state(self, batch: int) -> Any:
        return self.api.init_state(self.cfg, batch, self.scfg.max_len,
                                   getattr(torch, self.scfg.cache_dtype), self.device)

    def prefill(self, batch: dict[str, torch.Tensor], state: Any) -> tuple[torch.Tensor, Any]:
        """Last-position logits of the prompts; writes the cache.

        Raises:
            ValueError: the batch carries ``patches`` and its prompts are
                shorter than the ``n_patches`` positions the patches
                replace (the reference fails there with a shape error).
        """
        plen = batch["tokens"].shape[1]
        if self.cfg.n_patches and "patches" in batch and plen < self.cfg.n_patches:
            raise ValueError(f"a prompt of {plen} tokens is shorter than the "
                             f"{self.cfg.n_patches} positions its patches replace")
        m = self.scfg.max_len
        return self.api.prefill(self.params, batch, state, self.cfg,
                                q_chunk=min(512, m), kv_chunk=min(1024, m))

    def decode(self, tok: torch.Tensor, state: Any, cur_len: int) -> tuple[torch.Tensor, Any]:
        """Logits of one new token per row at position ``cur_len``."""
        return self.api.decode_step(self.params, {"tokens": tok}, state, cur_len, self.cfg)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        scaled = logits[:, -1].to(torch.float32) / self.scfg.temperature
        # Gumbel-max, the method of jax.random.categorical, on torch's bits
        u = torch.rand(scaled.shape, generator=gen, device=scaled.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)[:, None].to(torch.int32)

    def _clock(self) -> Any:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _seconds(self, a: Any, b: Any) -> float:
        return a.elapsed_time(b) / 1e3 if self.device.type == "cuda" else b - a

    def generate(
        self, prompts: np.ndarray, n_new_tokens: int, extras: dict[str, Any] | None = None
    ) -> np.ndarray:
        """prompts: (B, prompt_len) int32 -> (B, prompt_len + n_new_tokens).

        ``extras`` are the family's stub inputs (a VLM's ``patches``, an
        encoder-decoder's ``frames``), moved to the device for prefill.

        Raises:
            ValueError: the tokens exceed ``max_len``, or (from
                :meth:`prefill`) the prompts cannot hold their patches.
        """
        b, plen = prompts.shape
        if plen + n_new_tokens > self.scfg.max_len:
            raise ValueError(f"{plen} + {n_new_tokens} tokens exceed max_len {self.scfg.max_len}")
        state = self.init_state(b)
        toks = torch.as_tensor(np.asarray(prompts, np.int32), device=self.device)
        batch: dict[str, Any] = {"tokens": toks}
        if extras:
            batch.update({k: torch.as_tensor(v, device=self.device) for k, v in extras.items()})
        gen = torch.Generator(device=self.device).manual_seed(self.scfg.seed)
        t0 = self._clock()
        logits, state = self.prefill(batch, state)
        t1 = self._clock()
        tok = self._sample(logits, gen)
        out = [toks, tok]
        cur = plen
        for _ in range(n_new_tokens - 1):
            logits, state = self.decode(tok, state, cur)
            tok = self._sample(logits, gen)
            out.append(tok)
            cur += 1
        t2 = self._clock()
        result = torch.cat(out, dim=1).cpu().numpy()  # waits for the device
        self.last_timings = {"prefill_s": self._seconds(t0, t1),
                             "decode_s": self._seconds(t1, t2),
                             "decode_steps": n_new_tokens - 1}
        return result
