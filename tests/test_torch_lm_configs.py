"""The port's LM configs (dense, VLM, MoE) against the JAX package's, field
by field, and their parameter trees name for name, so that
``load_jax_params`` is a plain copy for every family. Exact throughout."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.utils.convert import load_jax_params

LM_ARCHS = ("qwen1.5-0.5b", "qwen1.5-32b", "gemma-7b", "internlm2-1.8b",
            "qwen2-vl-7b", "olmoe-1b-7b", "qwen2-moe-a2.7b")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_equals_jax_field_by_field(arch, reduced):
    ours = get_config(arch, reduced=reduced)
    ref = j_get_config(arch, reduced=reduced)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_every_lm_arch_is_registered():
    assert set(LM_ARCHS) <= set(list_archs())
    with pytest.raises(KeyError, match="item 13"):
        get_config("xlstm-1.3b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_count_equals_jax(arch):
    assert api.param_count(get_config(arch)) == \
        japi.param_count(j_get_config(arch))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_load_jax_params_names_match_one_to_one(arch):
    jcfg = j_get_config(arch, reduced=True)
    params = japi.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = api.init_model(get_config(arch, reduced=True), 0, device="cpu")
    ours = {n: tuple(p.shape) for n, p in tparams.named_parameters()}
    assert ours == _flat(params)
    load_jax_params(tparams, jax.tree_util.tree_map(np.asarray, params))
    assert torch.equal(tparams["embed"]["tok"],
                       torch.from_numpy(np.asarray(params["embed"]["tok"])))


@pytest.mark.parametrize("family,match", [("ssm", "xLSTM.*item 13"),
                                          ("encdec", "enc-dec.*item 13"),
                                          ("audio", "enc-dec.*item 13")])
def test_unported_families_name_their_item(family, match):
    cfg = get_config("qwen1.5-0.5b", reduced=True).replace(family=family)
    with pytest.raises(NotImplementedError, match=match):
        api.get_module(cfg)


def test_hybrid_lm_mode_names_its_item():
    from repro_torch.serve import make_decode_step, make_prefill
    cfg = get_config("zamba2-2.7b", reduced=True)
    for make in (lambda: make_prefill(cfg, 16), lambda: make_decode_step(cfg)):
        with pytest.raises(NotImplementedError, match="LM mode.*item 13"):
            make()
