"""The port's checkpoint loading (ai2bmd_torch.models.checkpoint,
simulators.load_model) against the JAX package's (ai2bmd_tpu.models.checkpoint),
on the CPU.

A synthetic Lightning ``.ckpt`` with the reference's key naming (the port's
own copy of tests/test_checkpoint.py's synthetic state dict) goes through
both packages' ``load_checkpoint``; converted ``.npz`` snapshots cross
between the packages in both directions; ``load_model`` takes its three
routes; a file that is not a checkpoint raises, naming it."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ai2bmd_tpu.models import checkpoint as JC
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_torch import simulators as TSIM
from ai2bmd_torch.models import checkpoint as TC
from ai2bmd_torch.models.params import flatten, init_params, params_from_jax
from ai2bmd_torch.models.visnet import ViSNetConfig

CFG = dict(hidden_channels=16, num_heads=2, num_layers=2, num_rbf=4, max_z=20)


def synthetic_state_dict(cfg, seed=0, scale=0.2):
    """A Lightning state_dict with the reference's keys (visnet.py:84-87)."""
    g = torch.Generator().manual_seed(seed)
    H, R = cfg.hidden_channels, cfg.num_rbf

    def t(*shape):
        # small scale: N(0,1) weights overflow the multiplicative attention
        return torch.randn(*shape, generator=g) * scale

    rm = "model.representation_model"
    sd = {
        f"{rm}.embedding.weight": t(cfg.max_z, H),
        f"{rm}.distance_expansion.means": t(R),
        f"{rm}.distance_expansion.betas": t(R).abs(),
        f"{rm}.neighbor_embedding.embedding.weight": t(cfg.max_z, H),
        f"{rm}.neighbor_embedding.distance_proj.weight": t(H, R),
        f"{rm}.neighbor_embedding.distance_proj.bias": t(H),
        f"{rm}.neighbor_embedding.combine.weight": t(H, 2 * H),
        f"{rm}.neighbor_embedding.combine.bias": t(H),
        f"{rm}.edge_embedding.edge_proj.weight": t(H, R),
        f"{rm}.edge_embedding.edge_proj.bias": t(H),
        f"{rm}.out_norm.weight": t(H),
        f"{rm}.out_norm.bias": t(H),
        f"{rm}.vec_out_norm.weight": t(H),
        "model.mean": torch.tensor(0.25),
        "model.std": torch.tensor(1.5),
        "model.prior_model.atomref.weight": t(cfg.max_z, 1),
        "model.prior_model.initial_atomref": t(cfg.max_z, 1),
    }
    for i in range(cfg.num_layers):
        b = f"{rm}.vis_mp_layers.{i}"
        sd[f"{b}.layernorm.weight"] = t(H)
        sd[f"{b}.layernorm.bias"] = t(H)
        sd[f"{b}.vec_layernorm.weight"] = t(H)
        sd[f"{b}.vec_proj.weight"] = t(3 * H, H)
        for name, (o, ii) in {
            "q_proj": (H, H), "k_proj": (H, H), "v_proj": (H, H),
            "dk_proj": (H, H), "dv_proj": (H, H),
            "s_proj": (2 * H, H), "o_proj": (3 * H, H),
        }.items():
            sd[f"{b}.{name}.weight"] = t(o, ii)
            sd[f"{b}.{name}.bias"] = t(o)
        if i < cfg.num_layers - 1:
            sd[f"{b}.f_proj.weight"] = t(H, H)
            sd[f"{b}.f_proj.bias"] = t(H)
            sd[f"{b}.w_src_proj.weight"] = t(H, H)
            sd[f"{b}.w_trg_proj.weight"] = t(H, H)
    om = "model.output_model.output_network"
    for bi, (hi, ho) in enumerate([(H, H // 2), (H // 2, 1)]):
        sd[f"{om}.{bi}.vec1_proj.weight"] = t(hi, hi)
        sd[f"{om}.{bi}.vec2_proj.weight"] = t(ho, hi)
        sd[f"{om}.{bi}.update_net.0.weight"] = t(hi, 2 * hi)
        sd[f"{om}.{bi}.update_net.0.bias"] = t(hi)
        sd[f"{om}.{bi}.update_net.2.weight"] = t(2 * ho, hi)
        sd[f"{om}.{bi}.update_net.2.bias"] = t(2 * ho)
    return sd


def hparams(cfg):
    return {
        "lmax": cfg.lmax, "embedding_dimension": cfg.hidden_channels,
        "num_heads": cfg.num_heads, "num_layers": cfg.num_layers,
        "num_rbf": cfg.num_rbf, "cutoff": cfg.cutoff, "max_z": cfg.max_z,
        "vecnorm_type": "none", "activation": "silu",
        "attn_activation": "silu", "reduce_op": "add",
        "model": "ViSNetBlock", "output_model": "Scalar",
        "prior_model": "Atomref", "derivative": True, "rbf_type": "expnorm",
        "trainable_rbf": False, "trainable_vecnorm": False,
    }


def write_ckpt(path, cfg, drop=(), **kw):
    """A synthetic Lightning checkpoint at ``path``, without the keys that
    contain any string of ``drop``."""
    sd = {k: v for k, v in synthetic_state_dict(cfg, **kw).items()
          if not any(d in k for d in drop)}
    torch.save({"state_dict": sd, "hyper_parameters": hparams(cfg)}, path)
    return str(path)


def assert_trees_equal(mine, ref):
    """The same paths (in any order of dict keys), every leaf a float32
    tensor bitwise equal to the other's."""
    a, b = dict(flatten(mine)), dict(flatten(ref))
    assert sorted(a, key=str) == sorted(b, key=str)
    for path, x in a.items():
        assert x.dtype == b[path].dtype == torch.float32, path
        assert torch.equal(x, b[path]), path


def jax_tree(params):
    return params_from_jax(jax.tree.map(np.asarray, params))


# the fields both configs have; the JAX one also has dtype and its kernel switches
SHARED = [f.name for f in dataclasses.fields(ViSNetConfig)
          if f.name in {g.name for g in dataclasses.fields(JV.ViSNetConfig)}]


def test_load_checkpoint_matches_jax(tmp_path):
    """The same config (every shared field) and every leaf equal to the JAX
    tree's, weights transposed to [in, out] on the way in."""
    jcfg = JV.ViSNetConfig(**CFG)
    path = write_ckpt(tmp_path / "visnet-uni-test.ckpt", jcfg)
    params, cfg = TC.load_checkpoint(path)
    jparams, jcfg2 = JC.load_checkpoint(path)
    assert {"reduce_op", "trainable_rbf"} <= set(SHARED)
    assert {f: getattr(cfg, f) for f in SHARED} == {f: getattr(jcfg2, f) for f in SHARED}
    assert cfg.hidden_channels == 16 and cfg.num_layers == 2
    assert_trees_equal(params, jax_tree(jparams))
    sd = synthetic_state_dict(jcfg)
    np.testing.assert_array_equal(
        params["layers"][0]["q_proj"]["w"].numpy(),
        sd["model.representation_model.vis_mp_layers.0.q_proj.weight"].numpy().T)
    assert float(params["mean"]) == 0.25 and float(params["std"]) == 1.5
    assert "f_proj" not in params["layers"][-1]


def test_missing_prior_defaults_to_zero(tmp_path):
    path = write_ckpt(tmp_path / "noprior.ckpt", JV.ViSNetConfig(**CFG), drop=("prior_model",))
    params, cfg = TC.load_checkpoint(path)
    assert params["atomref"].shape == (cfg.max_z, 1)
    assert torch.equal(params["atomref"], torch.zeros((cfg.max_z, 1)))
    assert_trees_equal(params, jax_tree(JC.load_checkpoint(path)[0]))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_converted_npz_loads_in_the_other_package(tmp_path, writer):
    """A snapshot written by either package loads in both with equal leaves
    and an equal config."""
    jcfg = JV.ViSNetConfig(**CFG)
    params, cfg = TC.load_checkpoint(write_ckpt(tmp_path / "x.ckpt", jcfg))
    npz = str(tmp_path / "converted.npz")
    if writer == "torch":
        TC.save_converted(npz, params, cfg)
    else:
        jparams, jc = JC.load_checkpoint(str(tmp_path / "x.ckpt"))
        JC.save_converted(npz, jparams, jc)
    t_params, t_cfg = TC.load_converted(npz)
    j_params, j_cfg = JC.load_converted(npz)
    assert_trees_equal(t_params, params)
    assert_trees_equal(jax_tree(j_params), params)
    assert t_cfg == cfg
    assert {f: getattr(t_cfg, f) for f in SHARED} == {f: getattr(j_cfg, f) for f in SHARED}


@pytest.mark.parametrize("route", ["npz", "ckpt", "random"])
def test_load_model_routes(tmp_path, route):
    """load_model: a .npz through load_converted, a path that exists through
    load_checkpoint (both ignore the cfg passed in), anything else random
    weights from the seed with the cfg passed in."""
    small = ViSNetConfig(**CFG)
    ckpt = write_ckpt(tmp_path / "visnet-uni-1.ckpt", JV.ViSNetConfig(**CFG))
    ref_params, ref_cfg = TC.load_checkpoint(ckpt)
    cfg_in = ViSNetConfig(num_layers=1)
    if route == "npz":
        path = str(tmp_path / "w.npz")
        TC.save_converted(path, ref_params, ref_cfg)
    elif route == "ckpt":
        path = ckpt
    else:
        path, cfg_in = str(tmp_path / "absent.ckpt"), small
        ref_params, ref_cfg = init_params(small, torch.Generator().manual_seed(3)), small
    params, cfg = TSIM.load_model(path, cfg_in, seed=3)
    assert cfg == ref_cfg
    assert_trees_equal(params, ref_params)


@pytest.mark.parametrize("kind", ["garbage.ckpt", "garbage.npz", "no-weight.ckpt",
                                  "wrong-shape.npz"])
def test_a_file_that_is_not_a_checkpoint_raises_naming_it(tmp_path, kind):
    path = tmp_path / kind
    jcfg = JV.ViSNetConfig(**CFG)
    if kind.startswith("garbage"):
        path.write_bytes(b"not a checkpoint")
    elif kind == "no-weight.ckpt":
        write_ckpt(path, jcfg, drop=("vis_mp_layers.1.s_proj.weight",))
    else:
        params, cfg = TC.load_checkpoint(write_ckpt(tmp_path / "x.ckpt", jcfg))
        params["layers"][0]["q_proj"]["w"] = params["layers"][0]["q_proj"]["w"][:, :8]
        TC.save_converted(str(path), params, cfg)
    with pytest.raises(ValueError, match=kind):
        TSIM.load_model(str(path))
