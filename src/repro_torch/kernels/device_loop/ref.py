"""Plain PyTorch version of the device loop's condition kernel
(``csrc/device_loop.cu``): the ``cond`` of the JAX package's multi-round
``lax.while_loop``s (``repro.serve.executor``, ``multi_fn`` and
``roll_fn``) as the kernel computes it, one in-place update of the loop's
control words a call.

``ctrl`` is int32 [4]: 0 the budget (rounds the program may run), 1 rounds
run so far, 2 rounds run by every loop so far, 3 the condition (1: run
another round). ``done0`` [S] holds the done flags at the program's entry.
"""
from __future__ import annotations

import torch

EXIT_ON_ACCEPT = 1  # multi: leave at the first new accept
FIRST = 2           # the entry evaluation: i = 0, done0 = done


def loop_cond(i, budget, live, done, done0, exit_on_accept: bool):
    """The reference's loop condition: ``i < budget & any(live)``, and for
    ``multi`` also ``~any(done & ~done0)`` (no lane accepted since entry)."""
    go = (i < budget) & live.any()
    if exit_on_accept:
        go = go & ~(done & ~done0).any()
    return go


def loop_step_ref(live, done, done0, ctrl, flags: int):
    """The kernel's update, in place: at entry (``flags & FIRST``) set
    ``done0 = done`` and ``ctrl[1] = 0``, else count one round in
    ``ctrl[1]`` and ``ctrl[2]``; then ``ctrl[3]`` = the condition. Returns
    ``ctrl[3]``. Tensor operations only, so it never waits for the device."""
    if flags & FIRST:
        done0.copy_(done)
        ran = torch.zeros((), dtype=torch.int32, device=ctrl.device)
    else:
        ran = ctrl[1] + 1
        ctrl[2] += 1
    go = loop_cond(ran, ctrl[0], live, done, done0,
                   bool(flags & EXIT_ON_ACCEPT))
    ctrl[1] = ran
    ctrl[3] = go.to(torch.int32)
    return ctrl[3]
