"""zamba2's SSD layers on a mesh by heads (``repro_torch.models.mamba2``:
``by_heads``, ``_by_heads``): the port on gloo ranks of the CPU against
its own one-device run, from the same seeded weights and inputs.

One module fixture runs ``test_torch_mesh_ranks.py``'s jobs ``ssd_heads``
(four ranks) and ``ssd_one`` (one rank) at once:

- ``ssd_heads``: reduced zamba2's first SSD layer on (data 1, model 4)
  under ``SERVE_RULES`` (its 8 heads 2 a rank), a forward over 32 tokens a
  rank and one over 64 (either side of the crossover, 47.9 tokens at the
  reduced widths), each followed by a decode step from its states, every
  call under ``collectives.CollectiveLog``. With few tokens the layer runs
  by heads: no parameter block and no SSM state block is ever an
  all-gather's input, and the states come back as the cache lays them
  out; with many, the forward gathers the parameters (its decode step,
  4 tokens, runs by heads). Both within 1e-5 relative L2 of one device.
- ``ssd_one``: the layer and reduced zamba2's prefill and six greedy
  decode steps on a (1, 1) mesh, which takes the heads path (one model
  rank): bitwise one device's, in f32 and bf16.

The (1, 4) mesh beside the JAX package is ``test_torch_lm_serve_mesh.py``'s
``zamba2-2.7b@1x4``; the dry run's census of a reduced decode cell is in
``test_torch_dryrun.py``.
"""
import os
import pickle

import numpy as np
import pytest

from test_torch_mesh_ranks import start_job, wait_all


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("ssd_heads"))
    wait_all(io_dir, [start_job("ssd_heads", io_dir),
                      start_job("ssd_one", io_dir)])
    out = {}
    for job in ("ssd_heads", "ssd_one"):
        with open(os.path.join(io_dir, f"{job}.pkl"), "rb") as f:
            out[job] = pickle.load(f)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()),
                                                 1e-30)


def test_crossover_is_tokens_against_parameters():
    """A pure function of the shapes and the mesh: a decode step of the
    production cells by heads, their prefill and train steps gathered,
    and one model rank always by heads."""
    from repro_torch.configs import get_config
    from repro_torch.models.mamba2 import by_heads

    full, small = get_config("zamba2-2.7b"), get_config("zamba2-2.7b",
                                                        reduced=True)
    assert by_heads(full, 8, 16) and by_heads(full, 1, 16)
    assert not by_heads(full, 65536, 16) and not by_heads(full, 2048, 16)
    assert by_heads(full, 65536, 1)
    assert by_heads(small, 47, 4) and not by_heads(small, 48, 4)


@pytest.mark.parametrize("case", ["few", "many"])
def test_layer_on_mesh_matches_one_device(runs, case):
    r = runs["ssd_heads"][case]
    for call in ("forward", "decode"):
        for key in ("y", "conv", "ssm"):
            got, want = r["mesh"][call][key], r["one"][call][key]
            assert got.shape == want.shape, (call, key)
            assert _rel(got, want) < 1e-5, (call, key)


def _gathered(shapes):
    """The input shapes of every all-gather in a call's log."""
    return {shape for op, _, ins in shapes if op.startswith("all_gather")
            for shape in ins}


def test_few_tokens_gather_no_parameter_and_no_state(runs):
    r = runs["ssd_heads"]
    assert r["few"]["by_heads"] and r["few"]["tokens"] < 48
    blocks = set(r["params"].values())
    for call in ("forward", "decode"):
        got = r["few"]["mesh"][call]
        ssm_block = got["ssm"].shape[:1] + (got["ssm"].shape[1] // 4,) \
            + got["ssm"].shape[2:]
        gathered = _gathered(got["shapes"])
        assert gathered and not gathered & blocks, (call, gathered)
        assert ssm_block not in gathered, call
        # the states as the cache lays them out: conv channels and SSM
        # heads on model, never gathered whole
        assert got["layout"] == ["(Shard(dim=0), Shard(dim=2))",
                                 "(Shard(dim=0), Shard(dim=1))"], call
        # the [B, S, D] output all-reduced over model
        assert any(op.startswith("all_reduce") and axis == "model"
                   and ins[0][-1] == r["d"] for op, axis, ins in got["shapes"])


def test_many_tokens_gather_the_parameters(runs):
    """The forward over 64 tokens a rank gathers the parameters; the
    decode step after it (4 tokens) runs by heads from the states the
    gathered layout returned."""
    r = runs["ssd_heads"]
    assert not r["many"]["by_heads"] and r["many"]["tokens"] >= 48
    gathered = _gathered(r["many"]["mesh"]["forward"]["shapes"])
    assert {r["params"]["in_proj"], r["params"]["out_proj"]} <= gathered
    gathered = _gathered(r["many"]["mesh"]["decode"]["shapes"])
    assert not gathered & set(r["params"].values())


def test_one_rank_mesh_is_bitwise_one_device(runs):
    r = runs["ssd_one"]
    for call in ("forward", "decode"):
        for key in ("y", "conv", "ssm"):
            np.testing.assert_array_equal(r["layer"]["mesh"][call][key],
                                          r["layer"]["one"][call][key])
    for dt in ("float32", "bfloat16"):
        one, on_mesh = r[dt]["one"], r[dt]["mesh"]
        np.testing.assert_array_equal(on_mesh["prefill"], one["prefill"])
        assert len(on_mesh["decode"]) == len(one["decode"]) > 0
        for a, b in zip(on_mesh["decode"], one["decode"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(on_mesh["tokens"], one["tokens"])
