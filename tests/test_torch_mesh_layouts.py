"""Layouts that only a mesh wider than one rank forces: the port on four
gloo ranks of the CPU against its own one-device run, from the same seeded
parameters and inputs.

One module fixture runs ``test_torch_mesh_ranks.py``'s job ``layouts``
once. In it every call to ``DTensor.redistribute`` is counted by the
function that made it, so that each test can show that its re-layout ran:

- ``rows``: two exact train steps of reduced ``qwen1.5-0.5b`` on (data 4,
  model 1) under ``TRAIN_RULES`` with 2 microbatches of 8 rows: the
  microbatch dim cannot take the 4 data ranks, so ``step_loss_and_grads``
  makes the rows whole first (``split``). Loss within 1e-5 relative,
  ``grad_norm`` 1e-6, each parameter 1e-5 relative L2 (the limits of
  ``test_torch_mesh_steps.py``'s mesh-against-one-device check).
- ``kv_heads``: two exact train steps of reduced ``internlm2-1.8b`` with
  6 heads and 3 kv heads of 16 on (2, 2): k/v are split by head_dim over
  ``model`` and by embed over ``data`` (FSDP), and ``layers._tp_only``
  gathers the FSDP split before the q/k/v products (DTensor cannot
  unflatten the 3 heads of a product split over 2 ranks). The same
  limits.
- ``xlstm``: six decode steps of reduced ``xlstm-1.3b`` (2 heads) on
  (1, 4) under ``SERVE_RULES`` from an empty cache: the 2 heads do not
  divide the 4 model ranks, so ``sharding.split_last`` makes the inner
  dim whole before the head view. Logits within 1e-5 of one device's;
  the cache, made by ``init_cache`` under the context, laid out as
  ``cache_axes`` says.
- ``zeros``: a dense ``init_cache`` (the prefill's empty cache) under
  ``SERVE_RULES`` on (2, 2): each leaf a DTensor holding only its block,
  zeros, laid out as ``cache_axes`` says; ``len`` a plain host tensor.

- ``experts``, ``encdec``, ``xlstm_heads``: two exact train steps of
  reduced ``olmoe-1b-7b`` with 2 experts on (2, 2) (one expert a rank),
  ``seamless-m4t-medium`` on (2, 2) and ``xlstm-1.3b`` (2 heads) on (1, 4),
  the limits above. Their local blocks came out of the expert products,
  the q/k/v products' gradients and the mLSTM products in other strides
  than their global views', which DTensor then failed to view
  (``sharding.conform`` re-lays such a block on a mesh of more than one
  rank); xLSTM's sLSTM cell runs on each rank's rows.
- ``ssd_rows``: two exact train steps of reduced ``zamba2-2.7b`` on (2, 2):
  its SSD layers gather their FSDP-split parameters and run on each
  rank's rows, the rows split over ``data``; each gathered parameter's
  gradient comes back summed over the row splits
  (``sharding.whole_for_rows``; taken as each rank's whole gradient it
  was about half one device's). The limits above.
- ``xlstm_prefill``: reduced xLSTM's prefill and greedy decode on (2, 2)
  (one head a model rank) and on (1, 4) (two heads over four ranks, where
  the sLSTM's gate product could not be laid out), logits within 1e-5 of
  one device's, tokens equal.

A prefill and decode under a context on (2, 2), every family against the
reference, is ``test_torch_lm_serve_mesh.py``'s.
"""
import os
import pickle

import numpy as np
import pytest

from test_torch_mesh_ranks import start_job, wait_all


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("mesh_layouts"))
    wait_all(io_dir, [start_job("layouts", io_dir)])
    with open(os.path.join(io_dir, "layouts.pkl"), "rb") as f:
        return pickle.load(f)


def _rel_close(out, ref, rel, what=""):
    """||out - ref|| <= rel * ||ref|| (L2; a scalar's relative gap)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    gap = np.linalg.norm((out - ref).ravel())
    assert gap <= rel * max(np.linalg.norm(ref.ravel()), 1e-30), (what, gap)


def _steps_close(r):
    """A case's mesh steps against one device's: loss 1e-5 relative,
    ``grad_norm`` 1e-6, each parameter 1e-5 relative L2."""
    for tm, om in zip(r["mesh"]["metrics"], r["one"]["metrics"],
                      strict=True):
        _rel_close(tm["loss"], om["loss"], 1e-5, "loss")
        _rel_close(tm["grad_norm"], om["grad_norm"], 1e-6, "grad_norm")
    for i, (a, b) in enumerate(zip(r["mesh"]["params"], r["one"]["params"],
                                   strict=True)):
        _rel_close(a, b, 1e-5, ("params", i))


@pytest.mark.parametrize("case,relayout", [("rows", "split"),
                                           ("kv_heads", "_tp_only")])
def test_mesh_train_step_matches_one_device(layouts, case, relayout):
    r = layouts[case]
    assert r["redistributed"][relayout] > 0, r["redistributed"]
    _steps_close(r)


@pytest.mark.parametrize("case", ["experts", "encdec", "xlstm_heads"])
def test_conformed_train_step_matches_one_device(layouts, case):
    """Steps whose local blocks DTensor took in other strides than their
    global view's (the expert products with one expert a rank, the enc-dec
    q/k/v gradients, xLSTM's heads over more model ranks than heads): the
    same limits as the re-laid steps above."""
    _steps_close(layouts[case])


def test_gathered_ssd_train_step_matches_one_device(layouts):
    """zamba2's SSD layers on each rank's rows with their parameters
    gathered, the rows split over ``data``: the gathered parameters'
    gradients summed over the row splits, as one device's."""
    _steps_close(layouts["ssd_rows"])


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_xlstm_prefill_on_mesh_matches_one_device(layouts, shape):
    """xLSTM's prefill and greedy decode: one head a model rank (2, 2);
    two heads over four model ranks (1, 4)."""
    r = layouts["xlstm_prefill"][shape]
    np.testing.assert_allclose(r["mesh"]["prefill"], r["one"]["prefill"],
                               rtol=0, atol=1e-5)
    for a, b in zip(r["mesh"]["decode"], r["one"]["decode"], strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(r["mesh"]["tokens"], r["one"]["tokens"])


def test_rows_are_gathered_only_where_microbatches_need_it(layouts):
    """On (2, 2) with one microbatch the rows keep their split."""
    assert layouts["kv_heads"]["redistributed"]["split"] == 0


def test_xlstm_decode_with_heads_not_dividing_model(layouts):
    r = layouts["xlstm"]
    assert r["heads"] % 4 and r["redistributed"]["split_last"] > 0
    for i, (a, b) in enumerate(zip(r["mesh"]["decode"], r["one"]["decode"],
                                   strict=True)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                   err_msg=f"decode step {i}")
    assert {k: v for k, v in r["mesh"]["cache"].items() if k != "len"} == \
        r["want"]
    assert r["mesh"]["cache"]["len"] == "None"
    assert set(r["one"]["cache"].values()) == {"None"}


def test_init_cache_under_a_context_holds_blocks_of_zeros(layouts):
    z = layouts["zeros"]
    assert sorted(z) == ["k", "len", "v"]
    for k, leaf in z.items():
        shape, dtype = leaf["spec"]
        assert leaf["global"] == shape and leaf["dtype"] == dtype
        assert leaf["nonzero"] == 0 and leaf["device"] == "cpu"
        if k == "len":
            assert not leaf["dtensor"] and leaf["local"] == shape
            continue
        assert leaf["dtensor"] and leaf["placements"] == leaf["want"]
        # batch on data (2), the 4 kv heads on model (2): a quarter a rank
        assert np.prod(leaf["local"]) * 4 == np.prod(shape)
