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
    from repro_torch.core import chords_sample, uniform_tgrid
    from repro_torch.diffusion import init_wrapper
    from repro_torch.launch import serve as launch_serve
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
    }


@pytest.mark.parametrize("name", ["ContinuousEngine", "ChordsEngine",
                                  "StreamingSampler", "chords_sample",
                                  "init_wrapper", "launch.serve"])
def test_entry_point_defaults_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
