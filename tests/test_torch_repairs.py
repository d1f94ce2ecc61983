"""Repairs of three port faults, each held to a test that failed before it.

1. Abutting spans in an exported trace: a lane migration ends one
   ``request/compute`` span at the reading where the next one starts. The
   exporter used to convert ``ts`` and ``dur`` to microseconds separately,
   so past 2**23 us (8.4 s of trace age) ``ts + dur`` could pass the next
   span's ``ts`` by an ulp, more than the checkers' 1e-9 us slack. The test
   shifts the tracer's clock to 40 s and holds many abutting pairs to both
   the port's checker and the reference's (``repro.obs.check``).
2. Row independence of the drift's f32 products (the out-projection and
   the time MLP): a row's bits must not depend on how many rows share the
   call (the card's GEMM is chosen by shape). On the CPU the test holds the
   pieced products bitwise across 1, 2 and 4 slots' rows; the card's test
   is in ``tests/test_torch_kernels_gpu.py``.
3. Flash attention at head dim 256: the launch plan takes it on both
   routes (``tests/test_torch_kernel_plans.py`` holds the plans; the card's
   test against the plain version is in ``tests/test_torch_kernels_gpu.py``).
"""
import json

import numpy as np
import pytest
import torch

from repro.obs import check as j_check
from repro_torch.diffusion.wrapper import (OUT_PIECE_ROWS, TIME_PIECE_ROWS,
                                           out_project, row_product)
from repro_torch.obs import check as t_check
from repro_torch.obs.export import chrome_trace, span_dur_us
from repro_torch.obs.trace import Tracer


def _abutting_trace(n_pairs=2000, age_s=40.0, seed=0):
    """One slot track of ``n_pairs`` migration-like abutting compute spans,
    every reading past ``age_s`` seconds of trace age, plus a host dispatch
    span nested in each."""
    tr = Tracer()
    tr._t0 -= age_s  # the tracer has run for age_s seconds already
    rng = np.random.default_rng(seed)
    t = age_s + float(rng.uniform(0, 1))
    for rid in range(n_pairs):
        t_mig = t + float(rng.uniform(1e-4, 0.2))
        tr.span("request/compute", t, track=("slots", 0), t1=t_mig, rid=rid,
                migrated=True)
        tr.span("dispatch/migrate", t, track=("host", 0), t1=t_mig)
        t = t_mig
    # the JSON round trip a written trace takes
    return json.loads(json.dumps(chrome_trace(tr)))


@pytest.mark.parametrize("checker", [t_check, j_check],
                         ids=["port", "reference"])
def test_abutting_spans_past_8s_pass_both_checkers(checker):
    doc = _abutting_trace()
    assert checker.validate_structure(doc) == []


def test_span_dur_reaches_the_end_reading():
    rng = np.random.default_rng(1)
    exact = 0
    for _ in range(5000):
        ts = float(rng.uniform(8.4e6, 1e8))
        end = ts + float(rng.uniform(0.0, 2e5))
        dur = span_dur_us(ts, end)
        assert dur >= 0.0 and ts + dur <= end
        exact += ts + dur == end
    assert exact >= 4990, exact


def test_out_projection_rows_do_not_depend_on_the_grid():
    """The out-projection of one slot's rows is bitwise the same alone and
    inside a grid of 2 and 4 slots (f32, K 64, N 16: the drift's shape at a
    narrow width), and equal to a plain product within f32 rounding."""
    gen = np.random.default_rng(2)
    rows, d, lat = 8 * 64, 64, 16
    h = torch.from_numpy(gen.standard_normal((4 * rows // 64, 64, d))
                         .astype(np.float32))
    w = torch.from_numpy(gen.standard_normal((d, lat)).astype(np.float32))
    alone = out_project(h[: rows // 64], w)
    for s in (2, 4):
        grid = out_project(h[: s * rows // 64], w)
        assert torch.equal(grid[: rows // 64], alone), s
    np.testing.assert_allclose(out_project(h, w).numpy(),
                               torch.einsum("bsd,dl->bsl", h, w).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert OUT_PIECE_ROWS == 512


@pytest.mark.parametrize("n", [1, 3, 8, 13, 16, 32])
def test_time_mlp_products_in_pieces(n):
    """The time MLP's products in pieces of 8 samples: any count (padded),
    a scalar time's 1-D embedding, bitwise per row across counts, and
    within f32 rounding of one product."""
    gen = np.random.default_rng(3)
    te = torch.from_numpy(gen.standard_normal((32, 40)).astype(np.float32))
    w = torch.from_numpy(gen.standard_normal((40, 24)).astype(np.float32))
    got = row_product(te[:n], w, TIME_PIECE_ROWS)
    assert got.shape == (n, 24)
    assert torch.equal(got, row_product(te, w, TIME_PIECE_ROWS)[:n])
    np.testing.assert_allclose(got.numpy(), (te[:n] @ w).numpy(),
                               rtol=1e-5, atol=1e-5)
    one = row_product(te[0], w, TIME_PIECE_ROWS)
    assert one.shape == (24,) and torch.equal(one, got[0])
