"""Build the CUDA sources under ``repro_torch/csrc`` at first use and load
them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout, where ``<hash>`` covers the source and the nvcc flags,
so an edited source builds anew and an unchanged one loads at once.  Every
source has a plain C interface (``extern "C"``), so nvcc never includes
PyTorch's headers.  ``build_all`` starts one nvcc per source, all at once.

There is no fallback: a missing ``nvcc``, a failed build or a library that
does not load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, a source did not compile, or a library did not load."""


def nvcc_path() -> str:
    """The nvcc on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    raise KernelBuildError(f"nvcc not found on PATH or at {DEFAULT_NVCC}")


def library_path(name: str, build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content and flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir / f"{name}-{digest[:16]}.so"


def _start(name: str, build_dir: pathlib.Path) -> tuple[pathlib.Path, subprocess.Popen | None, str]:
    """Start nvcc for one source unless its library is already built."""
    lib = library_path(name, build_dir)
    if lib.is_file():
        return lib, None, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc, tmp


def _finish(name: str, lib: pathlib.Path, proc: subprocess.Popen | None, tmp: str) -> str:
    """Wait for one nvcc; move its library into place; return its log."""
    if proc is None:
        log = lib.with_suffix(".log")
        return log.read_text() if log.is_file() else ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        pathlib.Path(tmp).unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    lib.with_suffix(".log").write_text(out)
    os.replace(tmp, lib)
    return out


def build_all(build_dir: pathlib.Path = BUILD_DIR) -> dict[str, str]:
    """Build every ``csrc/*.cu`` (one nvcc each, started together).

    Returns:
        ``{name: nvcc log}`` — the log holds ptxas's register and
        shared-memory report for each kernel.
    """
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [(n, *_start(n, build_dir)) for n in names]
    logs = {}
    try:
        for n, lib, proc, tmp in started:
            logs[n] = _finish(n, lib, proc, tmp)
    finally:
        for _, _, proc, _ in started:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return logs


def load(name: str, build_dir: pathlib.Path = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if needed."""
    if name not in _LOADED:
        lib, proc, tmp = _start(name, build_dir)
        _finish(name, lib, proc, tmp)
        try:
            _LOADED[name] = ctypes.CDLL(str(lib))
        except OSError as e:
            raise KernelBuildError(f"could not load {lib}: {e}") from e
    return _LOADED[name]
