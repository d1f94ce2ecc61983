"""ctypes binding of the device loop (``csrc/device_loop.cu``).

Replaces the ``cond`` of the JAX package's multi-round ``lax.while_loop``s
(``src/repro/serve/executor.py``, ``multi_fn`` and ``roll_fn``). The
condition kernel runs as a node of the ``multi`` loop program that
``repro_torch.serve.graphs`` builds: an entry node, then a conditional
WHILE node whose body is the captured round followed by the kernel, which
sets the node's condition for the next iteration
(``cudaGraphSetConditional``), so the device decides when the loop ends.
The batch stream program (``serve/graphs.py::GraphStream``) is the same
loop between a captured init and finish, its condition evaluated on
``~accepted`` with budget N.
Bound: launch latency (a few bytes per slot).

:func:`loop_step` launches the same kernel on its own (no graph), for the
eager programs, the tests and the smoke's comparison with the plain
version. The kernel counts its launches on the device, graph nodes
included (``kernels.launch_counts``), and as a graph node it also clocks
the loop program's device time (:func:`clock`). CUDA tensors only;
``ops.py`` picks the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.meta import CudaLaunch, OperandTile, dims3

_P = ctypes.c_void_p
_I = ctypes.c_int
THREADS = 128  # threads of the one block (csrc kThreads)


@functools.lru_cache(maxsize=64)
def launch_meta(s: int) -> CudaLaunch:
    """The condition kernel over S slot flags: one block of ``THREADS``,
    one pass over the flags; ``done0`` and the control words written (the
    same geometry as a loop program's kernel nodes)."""
    def whole(bx, by, bz):
        return (0,)

    flags = [OperandTile(n, (s,), "bool", (s,), whole)
             for n in ("live", "done")]
    outs = (OperandTile("done0", (s,), "bool", (s,), whole),
            OperandTile("ctrl", (4,), "int32", (4,), whole))
    return CudaLaunch("device_loop.device_loop_kernel", dims3(1),
                      dims3(THREADS), tuple(flags) + outs[1:], outs)


def outputs(live, done, done0, ctrl, *_):
    """What the wrapper returns (the condition, a view of ``ctrl``)."""
    return ctrl[3]


def _lib():
    return build.load("device_loop")


@functools.cache
def _fn(name: str):
    """The typed C entry points."""
    fn = getattr(_lib(), name)
    fn.argtypes = {
        "device_loop_step": [_P] * 4 + [_I, _I, _I, _P],
        "device_loop_graph_create": [_P] * 7 + [_I, _I, _P, _P, _P],
        "device_loop_graph_launch": [_P, _P],
        "device_loop_graph_destroy": [_P],
        "device_loop_versions": [_P, _P],
        "device_loop_clock": [_P, _I],
    }[name]
    fn.restype = _I
    return fn


def _check(err: int) -> None:
    if err:
        build.check(_lib(), "device_loop", err)


def _error_string(err: int) -> str:
    fn = _lib().device_loop_error_string
    fn.argtypes = [_I]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _flags_operands(live, done, done0, ctrl):
    s = live.shape
    if not (live.is_cuda and done.is_cuda and done0.is_cuda and ctrl.is_cuda):
        raise ValueError("device loop: needs CUDA tensors")
    if len(s) != 1 or s[0] < 1 or done.shape != s or done0.shape != s \
            or any(t.dtype != torch.bool for t in (live, done, done0)):
        raise ValueError(f"device loop: live/done/done0 must be [S] bool, "
                         f"got {tuple(live.shape)} {live.dtype}, "
                         f"{tuple(done.shape)} {done.dtype}, "
                         f"{tuple(done0.shape)} {done0.dtype}")
    if ctrl.shape != (4,) or ctrl.dtype != torch.int32:
        raise ValueError(f"device loop: ctrl must be int32 [4], got "
                         f"{tuple(ctrl.shape)} {ctrl.dtype}")
    if not all(t.is_contiguous() for t in (live, done, done0, ctrl)):
        raise ValueError("device loop: operands must be contiguous")
    return s[0]


def loop_step(live, done, done0, ctrl, flags: int):
    """One launch of the condition kernel: ``ref.loop_step_ref``'s update
    of ``done0`` and ``ctrl`` on the card. Returns ``ctrl[3]``."""
    s = _flags_operands(live, done, done0, ctrl)
    _check(_fn("device_loop_step")(
        live.data_ptr(), done.data_ptr(), done0.data_ptr(), ctrl.data_ptr(),
        s, int(flags), THREADS, build.stream_handle(live.get_device())))
    return outputs(live, done, done0, ctrl)


def graph_create(round_graph: int, live, done, done0, ctrl,
                 pre_graph: int = 0, post_graph: int = 0) -> int:
    """Build and instantiate a loop program (it leaves at the first new
    accept, or when no lane is live or the budget is spent) around the
    captured round ``round_graph`` (a ``cudaGraph_t`` as an int, kept alive
    by the caller), with the optional captured ``pre_graph`` before the
    entry kernel and ``post_graph`` after the loop (the stream program's
    init and finish). Returns the program's handle; raises, naming the
    node type CUDA refused, if it cannot be built."""
    s = _flags_operands(live, done, done0, ctrl)
    out, node, result = _P(), _I(-1), _I(0)
    err = _fn("device_loop_graph_create")(
        pre_graph or None, round_graph, post_graph or None,
        live.data_ptr(), done.data_ptr(), done0.data_ptr(),
        ctrl.data_ptr(), s, launch_meta(s).block[0], ctypes.byref(out),
        ctypes.byref(node), ctypes.byref(result))
    if err:
        raise RuntimeError(
            f"device loop graph not built: cudaError {err} "
            f"({_error_string(err)}), refused "
            f"node type {node.value}, cudaGraphInstantiateResult "
            f"{result.value}")
    return out.value


def graph_launch(handle: int, device_index: int) -> None:
    """Launch a loop program on the current stream."""
    _check(_fn("device_loop_graph_launch")(
        handle, build.stream_handle(device_index)))


def graph_destroy(handle: int) -> None:
    _check(_fn("device_loop_graph_destroy")(handle))


def clock(reset: bool = False) -> tuple:
    """The loop programs' device clock on the current device: (the last
    ``%globaltimer`` stamp, nanoseconds spent inside loop programs so far),
    from the condition kernel's graph nodes; ``reset`` zeroes the
    nanoseconds. Waits for the device."""
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 2)()
    _check(_fn("device_loop_clock")(out, int(bool(reset))))
    return out[0], out[1]


def versions() -> tuple:
    """(runtime the library was built with, driver), as 1000 * major +
    10 * minor: conditional WHILE nodes need 12040 for both."""
    rt, drv = _I(0), _I(0)
    _check(_fn("device_loop_versions")(ctypes.byref(rt), ctypes.byref(drv)))
    return rt.value, drv.value
