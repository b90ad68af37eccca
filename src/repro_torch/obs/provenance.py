"""Run provenance: the identity stamp to write next to any measured number
(port of ``repro.obs.provenance``).

Numbers from two runs compare only when the environment that produced them
is pinned beside them.  :func:`provenance_block` captures the run's
identity: the git sha and whether the tree was dirty, the torch and CUDA
runtime versions, the driver, and the card (its name, power limit and SM
count, since a card set below its maximum power runs slower under load),
plus the autotune cache schema and the process group's world size and
backend (1 and None without one).  :func:`provenance_problems` is the gate:
a block with a missing key, or a changed environment identity without a
re-baseline note, is a problem.
"""
from __future__ import annotations

import os
import platform as _platform
import subprocess
import sys
import time
from typing import Any

import torch

# The keys a block must carry; the absence of any one fails the gate.
REQUIRED_PROVENANCE_KEYS = (
    "git_sha",
    "torch_version",
    "cuda_runtime",
    "backend",
    "device_kind",
    "driver_version",
    "power_limit",
    "sm_count",
    "autotune_cache_schema",
)

# Keys whose change from a baseline to the current block demands a note.
ENV_IDENTITY_KEYS = ("torch_version", "cuda_runtime", "backend", "device_kind")

REBASELINE_ENV = "REPRO_BENCH_REBASELINE"


def _run(cmd: list[str], cwd: str | None = None) -> str | None:
    """stdout of ``cmd`` stripped, or None when it cannot run or fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def _git_sha(cwd: str | None = None) -> str:
    return _run(["git", "rev-parse", "HEAD"], cwd) or "unknown"


def _git_dirty(cwd: str | None = None) -> bool | None:
    out = _run(["git", "status", "--porcelain"], cwd)
    return None if out is None else bool(out)


def _card() -> dict[str, Any]:
    """The CUDA device 0's identity, or the CPU's when there is no card."""
    if not torch.cuda.is_available():
        return {"backend": "cpu", "device_kind": "cpu", "device_count": 0,
                "sm_count": None, "driver_version": None, "power_limit": None}
    props = torch.cuda.get_device_properties(0)
    smi = _run(["nvidia-smi", "--id=0", "--query-gpu=driver_version,power.limit",
                "--format=csv,noheader"])
    driver, power = (smi.split(", ", 1) if smi and ", " in smi else ("unknown", "unknown"))
    return {"backend": "cuda", "device_kind": props.name,
            "device_count": torch.cuda.device_count(),
            "sm_count": props.multi_processor_count, "driver_version": driver,
            "power_limit": power}


def provenance_block(cwd: str | None = None) -> dict[str, Any]:
    """Capture this process's run identity.  Never raises: a piece that
    cannot be read is ``"unknown"`` (or None where the CPU has none), and
    every required key is present."""
    from repro_torch.core import autotune

    block: dict[str, Any] = {
        "git_sha": _git_sha(cwd),
        "git_dirty": _git_dirty(cwd),
        "python_version": sys.version.split()[0],
        "platform": _platform.platform(),
        "torch_version": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "generated_unix_s": time.time(),
        "autotune_cache_schema": autotune.SCHEMA_VERSION,
    }
    block.update(_card())
    dist = torch.distributed
    running = dist.is_available() and dist.is_initialized()
    block["dist_world"] = dist.get_world_size() if running else 1
    block["dist_backend"] = dist.get_backend() if running else None
    note = os.environ.get(REBASELINE_ENV, "").strip()
    if note:
        block["rebaseline"] = note
    return block


def provenance_problems(current: dict[str, Any],
                        baseline: dict[str, Any] | None = None,
                        rebaseline_note: str = "") -> list[str]:
    """The gate: readable problems with ``current["provenance"]``.

    A missing block, a missing required key, and — when ``baseline`` has a
    block — any change of :data:`ENV_IDENTITY_KEYS` not covered by a
    re-baseline note (stamped in the current block, or passed here).
    """
    problems: list[str] = []
    block = current.get("provenance")
    if not isinstance(block, dict):
        return ["current artifact has no provenance block"]
    missing = [k for k in REQUIRED_PROVENANCE_KEYS if k not in block]
    if missing:
        problems.append("provenance block missing required keys: " + ", ".join(missing))
    base_block = (baseline or {}).get("provenance")
    if isinstance(base_block, dict):
        changed = [
            f"{k}: {base_block.get(k)!r} -> {block.get(k)!r}"
            for k in ENV_IDENTITY_KEYS
            if k in base_block and base_block.get(k) != block.get(k)
        ]
        note = (rebaseline_note or "").strip() or str(block.get("rebaseline", "")).strip()
        if changed and not note:
            problems.append(
                "environment identity changed without a re-baseline note ("
                + "; ".join(changed)
                + f"); set {REBASELINE_ENV} when generating or pass a note")
    return problems
