"""Program lint over ``make_fx`` graphs — the counterpart of
``repro.analysis.jaxpr_lint``.

Traces every program the :class:`RoundExecutor` can build (round / admit /
multi / roll / stream / migrate — see ``RoundExecutor.enumerate_programs``)
to an aten graph with ``make_fx(fn, tracing_mode="real")`` and flags:

* ``host-sync``    — ``aten._local_scalar_dense`` (``.item()``,
                     ``bool(t)``), ``item``, ``is_nonzero``, ``nonzero``,
                     or a copy to the CPU inside a program: the host waits
                     for the device every call, and a CUDA graph cannot
                     hold it (error). The reference's ``host-sync-obs``
                     has nothing to report here: the port's tracer
                     (``repro_torch.obs``) records host-side spans and
                     plants nothing inside a program.
* ``const-capture``— closure-captured tensors (``get_attr`` constants) of
                     1 KiB or more: baked into every trace (info).
* ``dtype-64``     — a float64 or complex128 value anywhere, or an int64
                     one among a program's outputs or state (torch's
                     indexing ops return int64 by design; the reference
                     keeps the state int32) (error).
* ``weak-widen``   — a Python scalar or 0-dim tensor widening a result
                     beyond every (>0-dim) tensor operand's dtype, the
                     silent-promotion pattern (warning).
* ``carry-drift``  — a state leaf out of round / admit / the loops /
                     migrate that differs in shape or dtype from the leaf
                     that went in (error).
* ``dead-code``    — ``call_function`` nodes whose value nothing uses and
                     that neither mutate an operand nor return a view of
                     one (warning).

The device loops are linted as the loop programs the card runs (entry
condition, then the WHILE body: round and condition kernel), never as the
host loop the CPU drives them with.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from repro_torch.analysis.report import Finding

PASS = "graph"

CONST_CAPTURE_BYTES = 1 << 10  # 1 KiB — below this, a baked const is noise

_A = torch.ops.aten
HOST_SYNC_OPS = frozenset({
    _A._local_scalar_dense.default, _A.item.default, _A.is_nonzero.default,
    _A.nonzero.default})
_WIDE = (torch.float64, torch.complex128)
CARRY_KINDS = ("round", "admit", "multi", "roll", "migrate")


def trace(rec):
    """``make_fx`` of a record's program through a fresh wrapper (so no
    trace is reused): (graph module, the outputs the traced run gave)."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    box = []

    def fn(*a):
        box.append(rec.fn(*a))
        return box[-1]

    # a host read (``.item()``, ``bool(t)``) is recorded as a node, which
    # the lint reports, instead of failing the trace. One fake mode for
    # every node's metadata (make_fx builds one a node otherwise, which
    # takes half a trace's time).
    with torch.no_grad(), tracing(TracingContext(
            FakeTensorMode(allow_fallback_kernels=True))):
        gm = make_fx(fn, tracing_mode="real",
                     _error_on_data_dependent_ops=False)(*rec.args)
    return gm, box[-1]


def _val(node):
    return node.meta.get("val")


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _op_name(node) -> str:
    return getattr(node.target, "__name__", str(node.target)).split(".")[0]


def _is_host_copy(node) -> bool:
    if _op_name(node) not in ("_to_copy", "copy_", "to"):
        return False
    dev = node.kwargs.get("device")
    return dev is not None and torch.device(dev).type == "cpu" and any(
        isinstance(v, torch.Tensor) and v.device.type != "cpu"
        for v in (_val(a) for a in node.args
                  if isinstance(a, torch.fx.Node)))


def _mutates_or_aliases(node) -> bool:
    """The op writes an operand, or returns a view of one (a dropped view
    computes nothing)."""
    schema = getattr(node.target, "_schema", None)
    return schema is not None and (schema.is_mutable or any(
        r.alias_info is not None for r in schema.returns))


def _operands(node):
    """(tensor values, whether a Scalar argument or a 0-dim tensor is
    among them), by the op's schema."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return [], False
    tensors, scalar = [], False
    for i, arg in enumerate(schema.arguments):
        if i < len(node.args):
            a = node.args[i]
        elif arg.name in node.kwargs:
            a = node.kwargs[arg.name]
        else:
            continue
        v = _val(a) if isinstance(a, torch.fx.Node) else a
        kind = str(arg.type)
        if kind not in ("Scalar", "Tensor"):
            continue
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            tensors.append(v)
        elif isinstance(v, (torch.Tensor, int, float)) \
                and not isinstance(v, bool):
            scalar = True  # a Python number, or a 0-dim tensor
    return tensors, scalar


def _weak_widened(node) -> Optional[tuple]:
    """(operand dtype, result dtype) where a Python scalar or 0-dim tensor
    widened the result past every >0-dim tensor operand, else None."""
    if node.kwargs.get("dtype") is not None:
        return None  # a dtype asked for, not a promotion
    out = _val(node)
    if not isinstance(out, torch.Tensor) or out.dtype == torch.bool:
        return None
    tensors, scalar = _operands(node)
    if not tensors or not scalar:
        return None
    base = tensors[0].dtype
    for t in tensors[1:]:
        base = torch.promote_types(base, t.dtype)
    if out.dtype == base or torch.promote_types(base, out.dtype) != out.dtype:
        return None
    return (str(base).removeprefix("torch."),
            str(out.dtype).removeprefix("torch."))


def _state_out(rec, out):
    """The state a record's program returns (its first output for the
    loops), to hold against ``rec.args[0]``."""
    if rec.kind in ("multi", "roll"):
        return out[0]
    return out


def _carry_drift(rec, out) -> List[Finding]:
    if rec.kind not in CARRY_KINDS:
        return []
    findings = []
    ins, outs = _tensors(rec.args[0]), _tensors(_state_out(rec, out))
    if len(ins) != len(outs):
        return [Finding(PASS, "carry-drift", "error", f"{rec.name}:state",
                        f"{rec.name}: the state goes in with {len(ins)} "
                        f"leaves and comes out with {len(outs)}")]
    for i, (a, b) in enumerate(zip(ins, outs)):
        if a.shape != b.shape or a.dtype != b.dtype:
            findings.append(Finding(
                PASS, "carry-drift", "error", f"{rec.name}:leaf{i}",
                f"{rec.name}: state leaf {i} drifts {a.dtype}"
                f"{tuple(a.shape)} -> {b.dtype}{tuple(b.shape)}: the next "
                f"call sees another state"))
    return findings


def lint_graph(name: str, gm, rec=None, out=None) -> List[Finding]:
    """Lint one traced program; ``name`` anchors finding locations/keys.
    With its record and real outputs, also the state and output checks."""
    findings: List[Finding] = []
    graph = gm.graph

    for node in graph.nodes:
        if node.op != "get_attr":
            continue
        c = getattr(gm, node.target, None)
        if isinstance(c, torch.Tensor) and \
                c.numel() * c.element_size() >= CONST_CAPTURE_BYTES:
            shape = tuple(c.shape)
            findings.append(Finding(
                PASS, "const-capture", "info", f"{name}:const{shape}",
                f"{name}: closure captures a "
                f"{c.numel() * c.element_size()}-byte {shape} tensor; it "
                f"is baked into the program — pass it as an argument"))

    sync, wide, weak, dead = {}, {}, {}, {}
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        op = _op_name(node)
        if node.target in HOST_SYNC_OPS or _is_host_copy(node):
            sync[op] = sync.get(op, 0) + 1
        for v in _tensors(_val(node)):
            if v.dtype in _WIDE:
                key = (op, str(v.dtype).removeprefix("torch."))
                wide[key] = wide.get(key, 0) + 1
        ww = _weak_widened(node)
        if ww is not None:
            weak[ww] = weak.get(ww, 0) + 1
        if not node.users and not _mutates_or_aliases(node) \
                and node.target not in HOST_SYNC_OPS:
            dead[op] = dead.get(op, 0) + 1

    if out is not None:
        for v in _tensors(out):
            if v.dtype == torch.int64:
                wide[("output", "int64")] = wide.get(("output", "int64"),
                                                     0) + 1
    for op, n in sorted(sync.items()):
        findings.append(Finding(
            PASS, "host-sync", "error", f"{name}:{op}",
            f"{name}: {n}x {op} — the host waits for the device inside a "
            f"program, every call (and a CUDA graph cannot capture it)"))
    for (op, dt), n in sorted(wide.items()):
        findings.append(Finding(
            PASS, "dtype-64", "error", f"{name}:{op}:{dt}",
            f"{name}: {n}x {op} produces {dt} — a 64-bit value in a "
            f"32-bit program"))
    for (src, dst), n in sorted(weak.items()):
        findings.append(Finding(
            PASS, "weak-widen", "warning", f"{name}:{src}->{dst}",
            f"{name}: {n}x {src} operand widened to {dst} by a Python "
            f"scalar or 0-dim tensor"))
    for op, n in sorted(dead.items()):
        findings.append(Finding(
            PASS, "dead-code", "warning", f"{name}:{op}",
            f"{name}: {n}x {op} node(s) whose value nothing uses — a "
            f"dropped value still computed every call"))
    if rec is not None and out is not None:
        findings.extend(_carry_drift(rec, out))
    return findings


def run(records: Iterable, traced: Optional[list] = None) -> List[Finding]:
    """Lint every :class:`ProgramRecord`; ``traced`` (if given) collects
    each record's graph, in order, for ``trace_check``."""
    findings: List[Finding] = []
    for rec in records:
        gm, out = trace(rec)
        if traced is not None:
            traced.append(gm)
        findings.extend(lint_graph(rec.name, gm, rec, out))
    return findings
