"""Batched LM serving engine: prefill + decode with greedy/temperature
sampling (port of ``repro.serve.engine``).

Static-batch engine: one prefill, then one decode step per new token.  It
runs eagerly (the reference's ``jax.jit`` has no counterpart here).  The
prefill attention goes through the flash kernel on the card
(``repro_torch/csrc/flash_attention.cu``), once per layer; decode attention
is plain PyTorch.  Sampling draws from an explicit seeded
``torch.Generator``: the same seed gives the same tokens, but not
``jax.random``'s.

On a mesh (``ServeEngine(..., mesh=)``, a ``DeviceMesh`` over a running
process group) the engine runs the reference's ``lower_cell`` prefill and
decode: parameters at ``param_placements``, prompts and tokens at
``batch_placements``, the decode state at ``state_placements`` (each rank
allocating its own shard), under the reference's default rules
(``distributed.act_sharding.use_rules``).  Rank 0 samples from the logits
gathered whole and broadcasts the tokens, so every rank decodes the same
ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.su3.plan import resolve_device
from repro_torch.distributed import act_sharding, sharding
from repro_torch.launch import mesh as meshes
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

    With a ``mesh`` (``launch.mesh.make_mesh``; ``device`` is then the
    mesh's) the parameters, whole and the same on every rank, are placed
    on it (each rank keeps its shards), and every rank runs every call.
    ``kv_seq_shard`` places the caches whose kv heads do not divide the
    model axes along their sequence (the reference's ``lower_cell(...,
    kv_seq_shard=)``): MQA's, MLA's latents, Whisper's on a model axis of
    4; decode then combines each rank's partial softmax over its keys.

    ``last_timings`` holds the last :meth:`generate`'s phases in seconds:
    ``prefill_s`` and ``decode_s`` (between CUDA events on the card, host
    clock on the CPU) and ``decode_steps``.
    """

    def __init__(self, cfg: ModelConfig, params: torch.nn.Module, scfg: ServeConfig,
                 device: torch.device | str | None = None, *, mesh: Any = None,
                 kv_seq_shard: bool = False):
        self.cfg = cfg
        self.scfg = scfg
        self.api = registry.get(cfg)
        self.mesh = mesh
        self.kv_seq_shard = kv_seq_shard
        self.last_timings: dict[str, float] = {}
        self.rules = None
        if mesh is None:
            self.device = resolve_device(device)
            self.params = params.to(self.device)
            return
        self.device = meshes.rank_device(mesh)
        self.rules = sharding.default_rules(sharding.logical_mesh(mesh))
        self.params = registry.distribute_params(cfg, params, mesh, self.rules)

    def _rules(self):
        """The mesh's rules for the block (nothing without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return act_sharding.use_rules(self.mesh, self.rules)

    def _placed(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """``batch`` at ``batch_placements`` on a mesh (whole on every rank
        in, each rank's rows kept); as it is without one."""
        if self.mesh is None:
            return batch
        return sharding.distribute_batch(batch, self.mesh, self.rules)

    def init_state(self, batch: int) -> Any:
        return registry.init_state(self.cfg, batch, self.scfg.max_len,
                                   getattr(torch, self.scfg.cache_dtype), self.device,
                                   mesh=self.mesh, rules=self.rules,
                                   kv_seq_shard=self.kv_seq_shard)

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
        with self._rules():
            return self.api.prefill(self.params, self._placed(batch), state, self.cfg,
                                    q_chunk=min(512, m), kv_chunk=min(1024, m))

    def decode(self, tok: torch.Tensor, state: Any, cur_len: int) -> tuple[torch.Tensor, Any]:
        """Logits of one new token per row at position ``cur_len``."""
        with self._rules():
            return self.api.decode_step(self.params, self._placed({"tokens": tok}), state,
                                        cur_len, self.cfg)

    def _next(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """The sampled tokens (B, 1); on a mesh rank 0 samples from the
        logits gathered whole (a collective) and broadcasts them."""
        if self.mesh is None:
            return self._sample(logits, gen)
        full = sharding.whole(logits)
        if torch.distributed.get_rank() == 0:
            tok = self._sample(full, gen)
        else:
            tok = torch.empty((full.shape[0], 1), dtype=torch.int32, device=self.device)
        torch.distributed.broadcast(tok, src=0)
        return tok

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
        tok = self._next(logits, gen)
        out = [toks, tok]
        cur = plen
        for _ in range(n_new_tokens - 1):
            logits, state = self.decode(tok, state, cur)
            tok = self._next(logits, gen)
            out.append(tok)
            cur += 1
        t2 = self._clock()
        result = torch.cat(out, dim=1).cpu().numpy()  # waits for the device
        self.last_timings = {"prefill_s": self._seconds(t0, t1),
                             "decode_s": self._seconds(t1, t2),
                             "decode_steps": n_new_tokens - 1}
        return result
