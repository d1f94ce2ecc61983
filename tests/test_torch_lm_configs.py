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
    """Every LM config the reference serves is registered, with the same
    list; an unknown name raises."""
    from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
    from repro_torch.configs import ASSIGNED_ARCHS
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert set(LM_ARCHS) <= set(ASSIGNED_ARCHS) <= set(list_archs())
    for arch in ASSIGNED_ARCHS:
        assert api.lm_module(get_config(arch, reduced=True)) is not None
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


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


@pytest.mark.parametrize("family,module", [("ssm", "xlstm"),
                                           ("encdec", "encdec"),
                                           ("audio", "encdec")])
def test_unported_families_name_their_item(family, module):
    """The families that were still to port now map to their modules, as
    in the reference's ``_FAMILY``; an unknown family raises."""
    from repro.models import api as j_api
    cfg = get_config("qwen1.5-0.5b", reduced=True).replace(family=family)
    assert api.get_module(cfg).__name__ == f"repro_torch.models.{module}"
    assert j_api.get_module(cfg).__name__ == f"repro.models.{module}"
    with pytest.raises(NotImplementedError, match="no such family"):
        api.get_module(cfg.replace(family="nope"))


def test_hybrid_lm_mode_names_its_item():
    """The hybrid's LM mode serves: the steps build on ``zamba2``."""
    from repro_torch.models import zamba2
    from repro_torch.serve import make_decode_step, make_prefill
    cfg = get_config("zamba2-2.7b", reduced=True)
    assert api.lm_module(cfg) is zamba2
    assert callable(make_prefill(cfg, 16)) and \
        callable(make_decode_step(cfg))
