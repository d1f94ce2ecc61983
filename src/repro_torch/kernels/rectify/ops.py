"""Dispatcher for the fused step+rectify(+accept) update.

``use_kernel=True`` launches the CUDA kernel for CUDA tensors and runs the
plain version (``ref.py``) for CPU tensors — the plain version *is* the
kernel's float semantics, so flipping ``use_kernel`` on the CPU never
changes a bit. ``use_kernel=False`` always runs the plain version. A kernel
that fails to build or launch raises; there is no fallback.

DTensor operands (a mesh: the rows split over the slots' or cores' mesh
axes) run on each rank's own rows (:func:`_on_rows`): a row is a whole
latent, so the latents take no redistribute; ``prev``, indexed by slot,
goes in as this rank's slots, and the accept sums stay on each rank's
rows.
"""
from __future__ import annotations

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels import mesh, on_cuda
from repro_torch.kernels.rectify import kernel
from repro_torch.kernels.rectify.ref import (fused_step_rectify_accept_ref,
                                             fused_step_rectify_ref)


def _flat(t, rows):
    return t.reshape(rows, -1)


def step_rectify(x, f, x_up, f_up, x_snap, f_snap, dt, dsnap, fire,
                 use_kernel: bool = True):
    """Latents [R, ...] (flattened internally), dt/dsnap/fire [R]."""
    if is_dtensor(x):
        return _on_rows("step_rectify",
                        lambda *a: step_rectify(*a, use_kernel=use_kernel),
                        (x, f, x_up, f_up, x_snap, f_snap, dt, dsnap, fire))
    rows, shape = x.shape[0], x.shape
    args = [_flat(a, rows) for a in (x, f, x_up, f_up, x_snap, f_snap)]
    if use_kernel and on_cuda(x):
        out = kernel.fused_step_rectify(*[a.contiguous() for a in args],
                                        dt.contiguous(), dsnap.contiguous(),
                                        fire)
    else:
        out = fused_step_rectify_ref(*args, dt, dsnap, fire)
    return out.reshape(shape)


def step_rectify_accept(x, f, x_up, f_up, x_snap, f_snap, prev,
                        dt, dsnap, fire, use_kernel: bool = True):
    """Latents [R, ...], prev [P, ...] (R divisible by P; see ``ref.py``).
    Returns (x_new [R, ...], err_sq [R], out_sq [R])."""
    if is_dtensor(x):
        return _on_rows(
            "step_rectify_accept",
            lambda *a: step_rectify_accept(*a, use_kernel=use_kernel),
            (x, f, x_up, f_up, x_snap, f_snap, dt, dsnap, fire), prev=prev)
    rows, shape = x.shape[0], x.shape
    args = [_flat(a, rows) for a in (x, f, x_up, f_up, x_snap, f_snap)]
    prev2 = prev.reshape(prev.shape[0], -1)
    if use_kernel and on_cuda(x):
        out, err_sq, out_sq = kernel.fused_step_rectify_accept(
            *[a.contiguous() for a in args], prev2.contiguous(),
            dt.contiguous(), dsnap.contiguous(), fire)
    else:
        out, err_sq, out_sq = fused_step_rectify_accept_ref(
            *args, prev2, dt, dsnap, fire)
    return out.reshape(shape), err_sq, out_sq



def _on_rows(name, fn, args, prev=None):
    """``fn(*local args[, prev's rows])`` on each rank's rows: every
    DTensor of ``args`` laid out by its rows alone (dim 0 split as ``x``'s,
    the rest whole; a redistribute counted in ``REDISTRIBUTES`` where it
    was not), ``prev`` cut to the slots of this rank's rows. Outputs laid
    out as the rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.sharding import local_block

    x = args[0]
    dm = x.device_mesh
    lay = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in x.placements)
    locs = []
    for a in args + ((prev,) if prev is not None else ()):
        if not is_dtensor(a):
            locs.append(local_block(a, dm, lay))
            continue
        if tuple(a.placements) != lay:
            mesh.REDISTRIBUTES[name] += 1
            a = a.redistribute(dm, lay)
        locs.append(a.to_local())
    if prev is not None:  # prev goes in after the latents
        locs = locs[:6] + [locs[-1]] + locs[6:-1]
    out = fn(*locs)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(t, dm, lay, run_check=False)
                    for t in outs)
    return wrapped if isinstance(out, tuple) else wrapped[0]
