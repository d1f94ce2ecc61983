"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each family under ``src/repro_torch/csrc/<name>.cu`` exposes a plain C
interface (pointers, sizes and the stream as ``void*``/integers, returning
``cudaGetLastError()`` as an int), so it builds in seconds without
PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library is built at first use into ``build/kernels/`` at the repository
root (``REPRO_TORCH_BUILD_DIR`` overrides it), keyed by a hash of the source
and the flags, so editing a source rebuilds and an unchanged one loads the
cached ``.so``. :func:`build_all` starts one ``nvcc`` per source at once.
Nothing here runs at import time: this module is imported on hosts that
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
FAMILIES = ("rectify", "rmsnorm", "flash_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    proc.cmd = cmd  # type: ignore[attr-defined]
    return proc


def _finish(name: str, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(proc.tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode})"
                           f":\n{' '.join(proc.cmd)}\n{log}")
    os.replace(proc.tmp, out)  # atomic: a cut build never leaves a bad .so


def build_all(names: Iterable[str] = FAMILIES) -> Dict[str, float]:
    """Build every missing library, one ``nvcc`` per source, all started
    together. Returns the seconds from the start until each build finished
    (cached libraries are absent)."""
    with _lock:
        t0 = time.perf_counter()
        procs = {}
        for name in names:
            out = _lib_path(name)
            if not out.exists():
                procs[name] = (out, _start(name, out))
        seconds = {}
        for name, (out, proc) in procs.items():
            _finish(name, out, proc)
            seconds[name] = time.perf_counter() - t0
        return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one family, building it first if needed."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def check(lib: ctypes.CDLL, family: str, err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function
    (each library exports ``<family>_error_string`` for the message)."""
    if err == 0:
        return
    fn = getattr(lib, f"{family}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"CUDA launch of {family} failed: cudaError {err} "
                       f"({fn(err).decode()})")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def operand(t):
    """``t`` contiguous and 16-byte aligned, as the kernels' 16-byte
    ``cp.async`` loads need it (a contiguous view at an odd offset is
    copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
