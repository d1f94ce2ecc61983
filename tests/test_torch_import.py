"""The PyTorch port stands alone: no JAX, no ``repro``, and its entry
points refuse a GPU-less host unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def _entry_points():
    from repro_torch.configs import get_config
    from repro_torch.core import (GaussianMixture, chords_sample,
                                  paradigms_sample, sequential_sample,
                                  srds_sample, uniform_tgrid)
    from repro_torch.diffusion import init_wrapper
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import api, dense
    from repro_torch.serve import (ChordsEngine, ContinuousEngine,
                                   StreamingSampler)
    tg = uniform_tgrid(4)

    def drift(x, t):
        return -x

    return {
        "ContinuousEngine": lambda: ContinuousEngine(drift, (2,), 4, 2, tg),
        "ChordsEngine": lambda: ChordsEngine(drift, (2,), 4, 2, tg),
        "StreamingSampler": lambda: StreamingSampler(drift, 4, 2, tg),
        "chords_sample": lambda: chords_sample(drift, torch.zeros(2), tg,
                                               [0, 1]),
        "init_wrapper": lambda: init_wrapper(
            get_config("chords-dit-xl", reduced=True), 8),
        "launch.serve": lambda: launch_serve.main(["--reduced"]),
        "paradigms_sample": lambda: paradigms_sample(drift, torch.zeros(2),
                                                     tg, window=2),
        "srds_sample": lambda: srds_sample(drift, torch.zeros(2), tg,
                                           num_segments=2),
        "sequential_sample(heun)": lambda: sequential_sample(
            drift, torch.zeros(2), tg, method="heun"),
        "GaussianMixture.random": lambda: GaussianMixture.random(
            torch.Generator()),
        "api.init_model": lambda: api.init_model(
            get_config("qwen1.5-0.5b", reduced=True)),
        "dense.init_cache": lambda: dense.init_cache(
            get_config("qwen1.5-0.5b", reduced=True), 1, 8),
    }


@pytest.mark.parametrize("name", ["ContinuousEngine", "ChordsEngine",
                                  "StreamingSampler", "chords_sample",
                                  "init_wrapper", "launch.serve",
                                  "paradigms_sample", "srds_sample",
                                  "sequential_sample(heun)",
                                  "GaussianMixture.random", "api.init_model",
                                  "dense.init_cache"])
def test_entry_point_defaults_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


@pytest.mark.parametrize("script,args", [
    ("torch_quickstart.py", []),
    ("torch_train_denoiser.py", ["--steps", "1"]),
    ("torch_serve_diffusion.py", ["--requests", "1"]),
    ("torch_lm_generate.py", ["--gen-steps", "2"])])
def test_examples_default_to_cuda(script, args):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the CUDA default is valid here")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr, \
        proc.stderr[-2000:]


def test_slice_eight_modules_are_covered():
    """The modules of the sample-and-train slice are among those imported
    above without JAX."""
    assert {"repro_torch.core.baselines", "repro_torch.core.reward",
            "repro_torch.core.solvers", "repro_torch.diffusion.schedules",
            "repro_torch.diffusion.wrapper", "repro_torch.optim.optimizer",
            "repro_torch.dist.checkpoint", "repro_torch.utils.tree",
            "repro_torch.serve.graphs"} <= set(_port_modules())


def test_new_serving_modules_are_covered():
    """The elastic, lane and trace modules are among those imported above
    without JAX (the CLI's ``__main__`` included)."""
    mods = set(_port_modules())
    assert {"repro_torch.obs.export", "repro_torch.obs.check",
            "repro_torch.obs.__main__", "repro_torch.core.chords",
            "repro_torch.serve.executor"} <= mods


def test_obs_cli_checks_a_trace_with_jax_unimportable(tmp_path):
    """``python -m repro_torch.obs check`` on a trace the port wrote, in a
    process where importing ``jax`` or ``repro`` fails."""
    path = tmp_path / "trace.json"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.obs import MetricsRegistry, Tracer, "
        "write_chrome_trace\n"
        "from repro_torch.obs.__main__ import main\n"
        "t = Tracer()\n"
        "t.span('dispatch/round', t.now(), round_idx=0, gap_s=0.001)\n"
        "reg = MetricsRegistry()\n"
        "reg.counter('serve.host_syncs').inc(1)\n"
        "reg.gauge('serve.rounds_total').set(1.0)\n"
        f"write_chrome_trace({str(path)!r}, t, metrics=reg)\n"
        f"sys.exit(main(['check', {str(path)!r}]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "obs check: OK" in proc.stdout


def test_lm_slice_imports_no_jax():
    """``repro_torch.serve.steps``, ``repro_torch.models.moe`` and
    ``examples/torch_lm_generate.py`` import in a process where importing
    ``jax`` or ``repro`` fails, and leave both out of ``sys.modules``."""
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serve.steps, repro_torch.models.moe\n"
        "spec = importlib.util.spec_from_file_location('ex', "
        f"{str(ROOT / 'examples' / 'torch_lm_generate.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('jax.', "
        "'repro.')))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert {"repro_torch.serve.steps", "repro_torch.models.moe"} <= \
        set(_port_modules())
