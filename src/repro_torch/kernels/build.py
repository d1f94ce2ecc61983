"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each family under ``src/repro_torch/csrc/<name>.cu`` exposes a plain C
interface (pointers, sizes and the stream as ``void*``/integers, returning
``cudaGetLastError()`` as an int), so it builds in seconds without
PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library is built at first use into ``build/kernels/`` at the repository
root (``REPRO_TORCH_BUILD_DIR`` overrides it), keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so editing a
source rebuilds and an unchanged one loads the cached ``.so``.
:func:`build_all` starts one ``nvcc`` per source at once. Every family
includes ``csrc/launch_count.cuh``: its kernels count their own launches on
the device (:func:`launch_counts`). Nothing here runs at import time: this
module is imported on hosts that have no ``nvcc``.
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
from typing import Dict, Iterable, NamedTuple, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
FAMILIES = ("rectify", "rmsnorm", "flash_attention", "ssd_scan",
            "device_loop")
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
    # the shared headers (csrc/*.cuh) are part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
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


def stream_handle(device_index: int) -> int:
    """PyTorch's current CUDA stream on device ``device_index`` as a raw
    handle (an int, which ctypes passes for a ``c_void_p`` argument). Reads
    the handle without building a ``torch.cuda.Stream`` object: this runs
    once per kernel launch."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device_index)


def launch_counts(name: str, n: int, reset: bool = False) -> list:
    """The first ``n`` device launch counters of family ``name`` on the
    current device (``csrc/launch_count.cuh``), zeroed afterwards with
    ``reset``; zeros when the library was never loaded in this process (no
    kernel of it can have run). A synchronous copy: it waits for the
    device."""
    lib = _libs.get(name)
    if lib is None:
        return [0] * n
    out = (ctypes.c_ulonglong * n)()
    fn = lib.launch_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    check(lib, name, fn(out, n, int(bool(reset))))
    return list(out)


class LastLaunch(NamedTuple):
    """A family's last launch as its library recorded it
    (``csrc/launch_count.cuh``): what the host asked for, and from
    ``cudaFuncGetAttributes`` the launched kernel's static shared bytes,
    dynamic shared limit and registers a thread."""
    grid: tuple
    block: tuple
    cluster: tuple
    dynamic_smem: int
    static_smem: int
    max_dynamic_smem: int
    registers: int

    def geometry(self) -> tuple:
        """As ``kernels.meta.geometry`` gives a launch description."""
        return (self.grid, self.block, self.cluster, self.dynamic_smem,
                self.static_smem)


def last_launch(name: str) -> Optional[LastLaunch]:
    """The geometry of family ``name``'s last launch in this process
    (None when its library was never loaded)."""
    lib = _libs.get(name)
    if lib is None:
        return None
    out = (ctypes.c_longlong * 13)()
    fn = lib.last_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    check(lib, name, fn(out, 13))
    v = list(out)
    return LastLaunch(tuple(v[0:3]), tuple(v[3:6]), tuple(v[6:9]), *v[9:])


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def operand(t):
    """``t`` contiguous and 16-byte aligned, as the kernels' 16-byte
    ``cp.async`` loads need it (a contiguous view at an odd offset is
    copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
