"""Plain PyTorch SSD (Mamba2) intra-chunk block: ``ssd_chunk_ref`` op for op
``repro.kernels.ssd_scan.ref`` (one chunk, one head), and its form batched
over [G, H] (what the kernel computes in one launch). Every three-operand
product is contracted pairwise in the reference's association
(``(C·Bᵀ ∘ M)·xdt`` and ``(xdt·w)ᵀ·B``); nothing [G, H, Lc, Lc, hd]-sized is
built."""
from __future__ import annotations

import torch


def _causal_decay(cum):
    """M[..., l, m] = exp(cum_l - cum_m) for m <= l, else 0."""
    lc = cum.shape[-1]
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=cum.device))
    dlog = cum[..., :, None] - cum[..., None, :]
    return torch.where(mask, torch.exp(dlog), torch.zeros((), dtype=cum.dtype,
                                                           device=cum.device))


def ssd_chunk_ref(c_mat, b_mat, xdt, cum):
    """One chunk, one (batch, head):

    c_mat/b_mat: [Lc, N] (SSD C and B projections)
    xdt:         [Lc, hd] (dt-scaled inputs)
    cum:         [Lc] inclusive cumulative log-decay

    Returns (y_intra [Lc, hd], s_local [hd, N]):
      y_intra[l] = sum_{m<=l} (C_l . B_m) exp(cum_l - cum_m) xdt_m
      s_local    = sum_m exp(cum_last - cum_m) xdt_m B_m^T
    """
    g = c_mat @ b_mat.T  # [Lc, Lc]
    y = (g * _causal_decay(cum)) @ xdt
    w = torch.exp(cum[-1] - cum)  # [Lc]
    s_local = (xdt * w[:, None]).T @ b_mat  # [hd, N]
    return y, s_local


def ssd_chunk_batched_ref(c_mat, b_mat, xdt, cum):
    """``ssd_chunk_ref`` over a (G, H) grid, the kernel's signature.

    c_mat/b_mat: [G, Lc, N] (shared by the H heads); xdt: [G, H, Lc, hd];
    cum: [G, H, Lc]. Returns (y [G, H, Lc, hd], s_local [G, H, hd, N]).
    """
    g = torch.einsum("gln,gmn->glm", c_mat, b_mat)  # [G, Lc, Lc]
    y = torch.einsum("ghlm,ghmp->ghlp", g[:, None] * _causal_decay(cum), xdt)
    w = torch.exp(cum[..., -1:] - cum)  # [G, H, Lc]
    s_local = torch.einsum("ghmp,gmn->ghpn", xdt * w[..., None], b_mat)
    return y, s_local
