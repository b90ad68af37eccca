"""Fault-tolerant checkpointing: atomic, async, restart-friendly (port of
``repro.checkpoint.manager``).

  * one ``step_<N>/`` directory per checkpoint: the leaves in one ``.npz``
    and a JSON manifest (leaf paths, dtypes, shapes, step, extra state such
    as the pipeline step);
  * ATOMIC: written to ``step_<N>.tmp`` then ``os.rename``\\ d — a crashed
    writer can never leave a half checkpoint that restore would pick up;
  * ASYNC: ``save()`` copies the leaves to host memory (blocking only for
    that copy) and hands serialization to a worker thread — the train loop
    overlaps the next step with checkpoint IO;
  * retention: ``keep`` newest checkpoints are kept, older ones pruned;
  * restore picks the newest complete manifest; partial dirs are skipped.

A tree is any nesting of modules (their ``named_parameters()``), dicts
(sorted keys), lists and tuples with tensors at the leaves; :func:`leaves`
flattens it into ``(path, tensor)`` pairs in a fixed order.  The reference
rebuilds a new tree from its template; here :meth:`CheckpointManager.restore`
copies the saved values into the template's own tensors (the port keeps one
set of parameters and updates it in place).  bf16 leaves are stored as
their 16-bit patterns (numpy has no bf16) and the manifest keeps the dtype.

On a mesh (DTensor leaves, a process group running) ``save`` gathers each
leaf whole (``full_tensor()``, a collective every rank takes in the same
order) before the writer thread starts; rank 0 alone copies it to the host
and writes, the other ranks drop it before the next leaf.  ``wait`` ends
with a barrier, so no rank reads a checkpoint before it is complete.
``restore`` reads one leaf at a time and keeps each template leaf's own
shard at its placements, on whatever mesh the template lives: a checkpoint
of a (2, 2) mesh restores onto (1, 2).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import distribute, is_dtensor, whole


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    keep: int = 3
    async_save: bool = True


def leaves(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf of ``tree`` in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, torch.nn.Module):
        return [(f"{prefix}{n}", p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in leaves(t, f"{prefix}{i}/")]
    raise TypeError(f"{prefix or 'tree'}: a {type(tree).__name__} is not a tensor, module, "
                    "dict, list or tuple")


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().to("cpu", copy=True)
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.dir = pathlib.Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: dict[str, Any] | None = None) -> None:
        """Snapshot + async write. ``tree`` is any tree of tensors (see
        :func:`leaves`)."""
        self.wait()  # one outstanding save at a time
        found = leaves(tree)
        paths = [p for p, _ in found]
        dtypes = [str(t.dtype).removeprefix("torch.") for _, t in found]
        writes = not _distributed() or torch.distributed.get_rank() == 0
        host = []
        for _, t in found:  # every rank gathers, in this thread; rank 0 keeps
            x = whole(t)
            if writes:
                host.append(_to_numpy(x))
        payload_extra = dict(extra or {})
        if not writes:
            return

        def work() -> None:
            try:
                self._write(step, host, paths, dtypes, payload_extra)
            except BaseException as e:  # surfaced on the next save or wait
                self._error = e

        if self.cfg.async_save:
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()
        else:
            work()
            self._raise_if_failed()

    def _write(self, step: int, arrays: list[np.ndarray], paths: list[str], dtypes: list[str],
               extra: dict) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        manifest = {
            "step": step,
            "n_leaves": len(arrays),
            "paths": paths,
            "dtypes": dtypes,
            "shapes": [list(a.shape) for a in arrays],
            "extra": extra,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomicity boundary
        self._prune()

    def _prune(self) -> None:
        ckpts = sorted(self.all_steps())
        for s in ckpts[: -self.cfg.keep] if self.cfg.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        """Wait for the outstanding save (and, in a process group, for every
        rank: a barrier)."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if _distributed():
            if torch.distributed.get_backend() == "nccl":
                torch.distributed.barrier(device_ids=[torch.cuda.current_device()])
            else:
                torch.distributed.barrier()
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, dict[str, Any], int]:
        """-> (template with the saved values, extra, step).

        Copies each saved leaf into the template's tensor at the same path
        (a DTensor leaf takes its own shard at its own placements).

        Raises:
            FileNotFoundError: no complete checkpoint (or not ``step``).
            ValueError: the template's leaves differ from the checkpoint's
                in number, path, dtype or shape.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        found = leaves(template)
        if len(found) != manifest["n_leaves"]:
            raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves; template expects "
                             f"{len(found)}")
        for (path, t), want_path, dt, shape in zip(found, manifest["paths"], manifest["dtypes"],
                                                   manifest["shapes"]):
            if path != want_path or str(t.dtype) != f"torch.{dt}" or tuple(t.shape) != tuple(shape):
                raise ValueError(f"checkpoint leaf {want_path} torch.{dt} {tuple(shape)} does "
                                 f"not fit the template's {path} {t.dtype} {tuple(t.shape)}")
        with np.load(d / "arrays.npz") as z, torch.no_grad():
            for i, ((_, t), dt) in enumerate(zip(found, manifest["dtypes"])):
                x = _from_numpy(z[f"leaf_{i}"], dt)  # one leaf read at a time
                if is_dtensor(t):
                    t.to_local().copy_(distribute(x, t.device_mesh, t.placements).to_local())
                else:
                    t.copy_(x)
        return template, manifest.get("extra", {}), step
