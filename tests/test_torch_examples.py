"""The port's examples (``examples/torch/``) and serving tools
(``scripts/torch/``) on the CPU, each through its ``main(argv)`` with
``--device cpu`` at its smallest config: the plain versions stand for the
kernels, and no file falls back to the CPU unless told to.
"""
import importlib.util
import json
import pathlib

import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import roofline
from repro_torch.obs import Tracer
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_batched", "train_lm", "serve_lattices")


def _load(path: str):
    """The module of the file ``path`` (relative to the repository's root)."""
    spec = importlib.util.spec_from_file_location(pathlib.Path(path).stem, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example(name: str):
    return _load(f"examples/torch/{name}.py")


def tool(name: str):
    return _load(f"scripts/torch/{name}.py")


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("serve_batched", []), ("train_lm", ["--steps", "1"]),
    ("serve_lattices", []), ("profile_dispatch", ["--quick"])])
def test_the_card_is_the_default_and_is_not_replaced(monkeypatch, name, argv):
    """Without ``--device cpu`` each asks for the card and fails without it."""
    module = example(name) if name in EXAMPLES else tool(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_quickstart_on_the_cpu(capsys):
    assert example("quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "su3_mult vs oracle max err" in out and "'verified': True" in out
    assert "roofline L=32 on h100_sxm: 604.0 MB" in out and "bound by bytes" in out
    assert "h100_sxm bandwidth-bound GF/s (SoA): 5025" in out
    assert "v5e" not in out.lower() and "tpu" not in out.lower()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serve_batched_serves_every_arch_at_its_default_prompt(capsys, arch):
    """The default prompt holds the reduced VLM's 16 patch positions (and is
    a zamba prompt of at most 128 tokens); the VLM gets patches and the
    encoder-decoder frames as extras."""
    assert example("serve_batched").main(["--arch", arch, "--batch", "2", "--tokens", "3",
                                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch {arch} on cpu: generated (2, 19)" in out
    cfg = get_config(arch).reduced()
    want = sorted(k for k, on in (("frames", cfg.is_encoder_decoder),
                                  ("patches", cfg.n_patches)) if on)
    assert f"extras {want}" in out


def test_serve_batched_refuses_a_prompt_shorter_than_the_patches():
    with pytest.raises(ValueError, match="12 tokens is shorter than the 16 positions"):
        example("serve_batched").main(["--arch", "internvl2-26b", "--prompt-len", "12",
                                       "--device", "cpu"])


def test_train_lm_on_the_cpu(tmp_path, capsys):
    assert example("train_lm").main(["--arch", "internvl2-26b", "--steps", "3", "--batch", "2",
                                     "--seq-len", "32", "--checkpoint-dir", str(tmp_path),
                                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch internvl2-26b (reduced: 4L d128" in out and "on cpu" in out
    assert "loss " in out and " -> " in out
    assert any(tmp_path.iterdir())  # the final checkpoint


@pytest.mark.parametrize("argv", [["--chain", "4"], ["--chain", "2", "--bf16"], ["--tile", "16"]])
def test_serve_lattices_on_the_cpu(capsys, argv):
    assert example("serve_lattices").main(["--batch", "5", "--L", "2", "--device", "cpu",
                                           *argv]) == 0
    out = capsys.readouterr().out
    assert "served 5 lattices (L=2, 16 sites" in out and "on cpu" in out
    assert ("dtype=bfloat16 accum=float32" in out) == ("--bf16" in argv)


def test_serve_lattices_autotunes_into_its_cache_and_starts_tuned(tmp_path, monkeypatch, capsys):
    """``--autotune`` measures once into ``--cache-dir``, and a second run
    reads the tuned tile and chain depth from it.  The tuner's model needs
    a card's spec: without one it raises (the CPU has none), so the spec
    is the H100 SXM's here."""
    lattices = example("serve_lattices")
    argv = ["--batch", "5", "--L", "2", "--autotune", "--cache-dir", str(tmp_path),
            "--device", "cpu"]
    with pytest.raises(LookupError, match="no Hopper spec"):
        lattices.main(argv)
    monkeypatch.setattr(roofline, "current_hardware", lambda: roofline.H100_SXM)
    assert lattices.main(argv) == 0
    first = capsys.readouterr().out
    cache = json.loads((tmp_path / "su3_autotune.json").read_text())
    (entry,) = cache.values()
    assert lattices.main(argv) == 0
    second = capsys.readouterr().out
    assert json.loads((tmp_path / "su3_autotune.json").read_text()) == cache
    plan = f"tile={entry['config']['tile']} dtype=float32 chain_k={entry['config']['fused_k']}"
    assert plan in first and plan in second


def _served_records() -> Tracer:
    """Spans as the serving stack and a slab plan trace them: multiply
    dispatches and overlapped stencil steps with their phases."""
    tr = Tracer()
    for _ in range(3):
        tr.add_span("dispatch", 0.0, 0.010, kind="multiply", L=4, tile=64, k=2,
                    dtype="float32", compression="none", live=4, flops=864.0 * 256 * 2 * 4)
    for _ in range(2):
        with tr.span("stencil.step", L=4, tile=64, overlap=True, depth=1, hosts=2,
                     dtype="float32", compression="none", flops=576.0 * 256):
            for phase in ("stencil.exchange", "stencil.interior", "stencil.boundary"):
                with tr.span(phase):
                    pass
    tr.count("admitted", 3)
    return tr


def test_trace_report_renders_a_port_tracer_in_both_formats(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(roofline, "current_hardware", lambda: None)  # a host with no card
    tr, report = _served_records(), tool("trace_report")
    flat, chrome = tmp_path / "t.jsonl", tmp_path / "t.json"
    tr.to_jsonl(str(flat))
    tr.to_chrome_trace(str(chrome), metadata={"device_kind": "NVIDIA H100 80GB HBM3",
                                              "power_limit": "700.00 W"})
    # the Chrome trace names its card: the attribution joins that card's model
    assert report.main([str(chrome)]) == 0
    out = capsys.readouterr().out
    assert "(11 spans)" in out and "device_kind=NVIDIA H100 80GB HBM3" in out
    assert "\nstencil.step" in out and "\n  stencil.interior" in out  # a child, indented
    assert "admitted = 3" in out and "overlap schedule (2 steps)" in out
    assert "roofline of h100_sxm" in out and "multiply" in out and "L4/t64" in out
    # the flat trace names no card, and the host has none: no model unless --hw
    assert report.main([str(flat)]) == 0
    out = capsys.readouterr().out
    assert "(11 spans)" in out and "attribution: no card spec" in out
    assert report.main([str(flat), "--hw", "h100_pcie"]) == 0
    assert "roofline of h100_pcie" in capsys.readouterr().out
    assert report.main([str(tmp_path / "missing.jsonl")]) == 1


def test_profile_dispatch_trace_renders_through_trace_report(tmp_path, capsys):
    rows_path, flat, chrome = tmp_path / "rows.json", tmp_path / "d.jsonl", tmp_path / "d.json"
    profile = tool("profile_dispatch")
    assert profile.main(["--quick", "--device", "cpu", "--json", str(rows_path),
                         "--trace", str(flat)]) == 0
    payload = json.loads(rows_path.read_text())
    assert [r["name"] for r in payload["dispatch"]] == [
        "dispatch_overhead_L2", "megakernel_amortization_L2",
        "dispatch_overhead_L4", "megakernel_amortization_L4"]
    assert all(r["device"] == "cpu" for r in payload["dispatch"])
    assert payload["provenance"]["backend"] == "cpu"
    assert profile.main(["--quick", "--device", "cpu", "--trace", str(chrome)]) == 0
    capsys.readouterr()
    for path in (flat, chrome):
        assert tool("trace_report").main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "(20 spans)" in out and "profile.dispatch     20" in out
    assert "backend=cpu" in out  # the Chrome trace carries the run's provenance
    with pytest.raises(SystemExit):
        profile.main(["--quick", "--device", "cpu", "--json", str(tmp_path / "BENCH_su3.json")])
    assert not (tmp_path / "BENCH_su3.json").exists()
