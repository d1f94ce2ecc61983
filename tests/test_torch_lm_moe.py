"""The port's MoE layer against ``repro.models.moe`` on the CPU, same
numpy inputs and the JAX package's parameters: the output within 2e-5
(f32), the routing (``top_e``, the capacity, which assignments are kept,
the count of dropped ones) exactly. The reference's routing values are
not returned by its ``moe_ffn``; ``_jax_routing`` recomputes them with the
reference's own lines (``repro/models/moe.py:64-80``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as jmoe
from repro.utils.pspec import init_params as j_init_params
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.utils.convert import to_torch


def _jax_routing(p, cfg, x, num_groups):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    tg = b * s // num_groups
    cap = jmoe._capacity(tg, cfg)
    xg = x.reshape(num_groups, tg, d)
    logits = jnp.einsum("gtd,de->gte", xg, p["router"].astype(jnp.float32))
    top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)

    def one(top_e1):
        order = jnp.argsort(top_e1.reshape(-1), stable=True)
        se = top_e1.reshape(-1)[order]
        rank = jnp.arange(se.shape[0]) - jnp.searchsorted(se, se, side="left")
        return se, rank < cap

    se, keep = jax.vmap(one)(top_e)
    return np.asarray(top_e), np.asarray(se), np.asarray(keep), cap


def _setup(arch, capacity_factor=None, seed=0):
    jcfg = j_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe_capacity_factor=capacity_factor)
        tcfg = tcfg.replace(moe_capacity_factor=capacity_factor)
    p = j_init_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed),
                      jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    tp = jax.tree_util.tree_map(lambda a: to_torch(np.asarray(a)), p)
    return jcfg, tcfg, p, tp, x


@pytest.mark.parametrize("num_groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_ffn_matches_jax(arch, capacity_factor, num_groups):
    jcfg, tcfg, p, tp, x = _setup(arch, capacity_factor)
    ref = np.asarray(jmoe.moe_ffn(p, jcfg, jnp.asarray(x), num_groups))
    out = moe.moe_ffn(tp, tcfg, to_torch(x), num_groups)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)

    top_e, se, keep, cap = _jax_routing(p, jcfg, jnp.asarray(x), num_groups)
    r = moe.route(tp, tcfg, to_torch(x), num_groups)
    assert r["cap"] == cap
    np.testing.assert_array_equal(r["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(r["se"].numpy(), se)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    dropped = int((~keep).sum())
    assert int((~r["keep"]).sum()) == dropped
    if capacity_factor is not None:
        assert dropped > 0, "the small capacity factor should drop tokens"


@pytest.mark.parametrize("tokens,k,e,factor", [(24, 2, 8, 1.25), (4, 8, 64, 1.25),
                                               (2048, 8, 64, 1.25),
                                               (2048, 4, 60, 1.25),
                                               (100, 2, 8, 0.25)])
def test_capacity_equals_jax(tokens, k, e, factor):
    jcfg = j_get_config("olmoe-1b-7b").replace(
        experts_per_tok=k, num_experts=e, moe_capacity_factor=factor)
    tcfg = get_config("olmoe-1b-7b").replace(
        experts_per_tok=k, num_experts=e, moe_capacity_factor=factor)
    assert moe._capacity(tokens, tcfg) == jmoe._capacity(tokens, jcfg)

