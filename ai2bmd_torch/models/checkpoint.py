"""Checkpoint conversion: the reference's PyTorch-Lightning .ckpt -> the port's
parameter tree, and the converted-weight ``.npz`` snapshot.

Port of ``ai2bmd_tpu/models/checkpoint.py:39-201``.  The reference loads
``visnet-uni-{md5}.ckpt`` Lightning checkpoints whose state_dict keys carry
a ``model.`` prefix (reference: src/ViSNet/model/visnet.py:73-93); this
module maps that state_dict onto the tree ``models/params.py`` lays out
(the JAX package's layout: nested dicts, a list of layers, linear weights
``[in, out]``).  torch Linear stores ``[out, in]``, so every weight matrix
is transposed on the way in.  Key layout of the reference model
(ViSNetBlock + EquivariantScalar + Atomref):

    representation_model.embedding.weight                 [max_z, H]
    representation_model.distance_expansion.{means,betas}
    representation_model.neighbor_embedding.{embedding.weight,
        distance_proj.{weight,bias}, combine.{weight,bias}}
    representation_model.edge_embedding.edge_proj.{weight,bias}
    representation_model.vis_mp_layers.{i}.{layernorm.{weight,bias},
        vec_layernorm.weight, vec_proj.weight,
        q_proj|k_proj|v_proj|dk_proj|dv_proj|s_proj|o_proj.{weight,bias},
        f_proj.{weight,bias}, w_src_proj.weight, w_trg_proj.weight}
    representation_model.out_norm.{weight,bias}
    representation_model.vec_out_norm.weight
    output_model.output_network.{0,1}.{vec1_proj.weight, vec2_proj.weight,
        update_net.0.{weight,bias}, update_net.2.{weight,bias}}
    prior_model.atomref.weight                            [max_z, 1]
    mean, std                                             scalars

The ``.npz`` snapshot has the JAX package's format: one array a leaf under
its path joined by ``/`` (list positions as their index), and
``__config__`` (lmax, hidden, heads, layers, rbf, max_z), ``__cutoff__`` and
``__vecnorm__``; a file written by either package loads in the other.  A
file that is not such a checkpoint raises ``ValueError`` naming it.
"""

from __future__ import annotations

import numpy as np
import torch

from ai2bmd_torch.models.params import flatten, init_params, unflatten
from ai2bmd_torch.models.visnet import ViSNetConfig


def load_torch_state_dict(path: str) -> tuple[dict, dict]:
    """Returns (state_dict as numpy arrays with ``model.`` stripped,
    hyper_parameters)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        state = {
            (k[len("model."):] if k.startswith("model.") else k): v.numpy()
            for k, v in ckpt["state_dict"].items()
        }
    except Exception as exc:
        raise ValueError(f"{path} is not a Lightning checkpoint: {exc!r}") from exc
    return state, dict(ckpt.get("hyper_parameters", {}))


def config_from_hparams(hp: dict) -> ViSNetConfig:
    """The config from the reference's hyperparameter names (visnet.py:14-30)."""
    return ViSNetConfig(
        lmax=hp.get("lmax", 2),
        hidden_channels=hp.get("embedding_dimension", 256),
        num_heads=hp.get("num_heads", 8),
        num_layers=hp.get("num_layers", 9),
        num_rbf=hp.get("num_rbf", 32),
        cutoff=hp.get("cutoff", 5.0),
        max_z=hp.get("max_z", 100),
        vecnorm_type=hp.get("vecnorm_type") or "none",
        activation=hp.get("activation", "silu"),
        attn_activation=hp.get("attn_activation", "silu"),
        reduce_op=hp.get("reduce_op", "add"),
        trainable_rbf=hp.get("trainable_rbf", False),
    )


def _f32(a) -> torch.Tensor:
    """A leaf as a C-contiguous float32 tensor of its own."""
    return torch.from_numpy(np.asarray(a).astype(np.float32, order="C"))


def _lin(state, key, bias=True):
    p = {"w": state[f"{key}.weight"].T}
    if bias:
        p["b"] = state[f"{key}.bias"]
    return p


def params_from_state_dict(state: dict, cfg: ViSNetConfig) -> dict:
    """The reference state_dict (numpy arrays) as the port's parameter tree
    of float32 tensors.  A missing prior gives a zero atomref."""
    rm = "representation_model"
    p = {
        "embedding": state[f"{rm}.embedding.weight"],
        "rbf": {
            "means": state[f"{rm}.distance_expansion.means"],
            "betas": state[f"{rm}.distance_expansion.betas"],
        },
        "neighbor_embedding": {
            "embedding": state[f"{rm}.neighbor_embedding.embedding.weight"],
            "distance_proj": _lin(state, f"{rm}.neighbor_embedding.distance_proj"),
            "combine": _lin(state, f"{rm}.neighbor_embedding.combine"),
        },
        "edge_embedding": {"edge_proj": _lin(state, f"{rm}.edge_embedding.edge_proj")},
        "layers": [],
        "out_norm": {
            "scale": state[f"{rm}.out_norm.weight"],
            "bias": state[f"{rm}.out_norm.bias"],
        },
        "vec_out_norm": {"weight": state[f"{rm}.vec_out_norm.weight"]},
        "output": {},
        "mean": np.asarray(state["mean"], dtype=np.float32),
        "std": np.asarray(state["std"], dtype=np.float32),
    }
    for i in range(cfg.num_layers):
        base = f"{rm}.vis_mp_layers.{i}"
        lp = {
            "layernorm": {
                "scale": state[f"{base}.layernorm.weight"],
                "bias": state[f"{base}.layernorm.bias"],
            },
            "vec_layernorm": {"weight": state[f"{base}.vec_layernorm.weight"]},
            "vec_proj": _lin(state, f"{base}.vec_proj", bias=False),
            **{name: _lin(state, f"{base}.{name}")
               for name in ("q_proj", "k_proj", "v_proj", "dk_proj", "dv_proj", "s_proj",
                            "o_proj")},
        }
        if f"{base}.f_proj.weight" in state:  # absent on the last layer
            lp["f_proj"] = _lin(state, f"{base}.f_proj")
            lp["w_src_proj"] = _lin(state, f"{base}.w_src_proj", bias=False)
            lp["w_trg_proj"] = _lin(state, f"{base}.w_trg_proj", bias=False)
        p["layers"].append(lp)

    for bi in (0, 1):
        base = f"output_model.output_network.{bi}"
        p["output"][f"block{bi}"] = {
            "vec1_proj": _lin(state, f"{base}.vec1_proj", bias=False),
            "vec2_proj": _lin(state, f"{base}.vec2_proj", bias=False),
            "update0": _lin(state, f"{base}.update_net.0"),
            "update1": _lin(state, f"{base}.update_net.2"),
        }
    p["atomref"] = state.get("prior_model.atomref.weight",
                             np.zeros((cfg.max_z, 1), dtype=np.float32))
    return unflatten([(path, _f32(leaf)) for path, leaf in flatten(p)])


def load_checkpoint(path: str) -> tuple[dict, ViSNetConfig]:
    """One call: a Lightning .ckpt path -> (parameter tree, config)."""
    state, hp = load_torch_state_dict(path)
    cfg = config_from_hparams(hp)
    try:
        return params_from_state_dict(state, cfg), cfg
    except KeyError as exc:
        raise ValueError(f"{path} lacks the ViSNet weight {exc}") from exc


def _key(path: tuple) -> str:
    return "/".join(map(str, path))


def save_converted(path: str, params: dict, cfg: ViSNetConfig) -> None:
    """Snapshot a parameter tree and its config as ``.npz`` (the JAX
    package's format)."""
    flat = {_key(p): leaf.detach().cpu().numpy() for p, leaf in flatten(params)}
    flat["__config__"] = np.array(
        [cfg.lmax, cfg.hidden_channels, cfg.num_heads, cfg.num_layers, cfg.num_rbf, cfg.max_z],
        dtype=np.int64)
    flat["__cutoff__"] = np.array([cfg.cutoff])
    flat["__vecnorm__"] = np.array([cfg.vecnorm_type])
    np.savez_compressed(path, **flat)


def load_converted(path: str) -> tuple[dict, ViSNetConfig]:
    """A ``.npz`` snapshot (from either package) -> (parameter tree of
    float32 tensors, config).  Every leaf the config's tree has must be
    there with its shape."""
    try:
        with np.load(path, allow_pickle=False) as raw:
            ints = raw["__config__"]
            cfg = ViSNetConfig(
                lmax=int(ints[0]), hidden_channels=int(ints[1]), num_heads=int(ints[2]),
                num_layers=int(ints[3]), num_rbf=int(ints[4]), max_z=int(ints[5]),
                cutoff=float(raw["__cutoff__"][0]), vecnorm_type=str(raw["__vecnorm__"][0]))
            template = init_params(cfg, torch.Generator().manual_seed(0))
            leaves = []
            for p, tpl in flatten(template):
                a = raw[_key(p)]
                if a.shape != tuple(tpl.shape):
                    raise ValueError(f"{_key(p)} has shape {a.shape}, expected "
                                     f"{tuple(tpl.shape)}")
                leaves.append((p, _f32(a)))
    except FileNotFoundError:
        raise
    except Exception as exc:
        raise ValueError(f"{path} is not a converted ViSNet checkpoint: {exc!r}") from exc
    return unflatten(leaves), cfg
