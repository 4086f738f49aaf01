"""ViSNet parameters: the weight bridge from JAX and a torch initializer.

The parameter tree has the layout of ``ai2bmd_tpu/models/visnet.py:177-229``:
nested dicts (and a list of per-layer dicts under ``"layers"``) of tensors.
Linear weights keep the JAX ``[in, out]`` layout, so every linear layer is
``x @ w + b`` in both packages and nothing is transposed anywhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def params_from_jax(tree) -> dict:
    """The JAX parameter pytree, given as numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``), as a tree of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    return torch.as_tensor(np.array(tree))


def _uniform(gen, shape, bound, dtype):
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * bound


def _linear_init(gen, n_in, n_out, bias=True, dtype=torch.float32):
    """xavier-uniform weight, zero bias (torch's defaults, as in JAX)."""
    p = {"w": _uniform(gen, (n_in, n_out), math.sqrt(6.0 / (n_in + n_out)), dtype)}
    if bias:
        p["b"] = torch.zeros(n_out, dtype=dtype)
    return p


def _geb_init(gen, h_in, h_out, dtype):
    return {
        "vec1_proj": _linear_init(gen, h_in, h_in, bias=False, dtype=dtype),
        "vec2_proj": _linear_init(gen, h_in, h_out, bias=False, dtype=dtype),
        "update0": _linear_init(gen, 2 * h_in, h_in, dtype=dtype),
        "update1": _linear_init(gen, h_in, 2 * h_out, dtype=dtype),
    }


def rbf_init(cfg, dtype=torch.float32) -> dict:
    start = math.exp(-cfg.cutoff)
    return {
        "means": torch.linspace(start, 1.0, cfg.num_rbf, dtype=dtype),
        "betas": torch.full((cfg.num_rbf,), (2.0 / cfg.num_rbf * (1.0 - start)) ** -2,
                            dtype=dtype),
    }


def init_params(cfg, generator: torch.Generator, dtype=torch.float32) -> dict:
    """Random parameters with the JAX initializer's distributions
    (``visnet.py:148-219``): xavier-uniform weights, zero biases, standard
    normal embeddings.  Draws come from ``generator`` (a CPU generator), so
    the values differ from JAX's for the same seed; the tests move JAX's
    values across with ``params_from_jax`` instead."""
    H, R = cfg.hidden_channels, cfg.num_rbf
    g = generator
    normal = lambda n, d: torch.randn((n, d), generator=g, dtype=dtype)
    lin = lambda *a, **k: _linear_init(g, *a, dtype=dtype, **k)
    p = {
        "embedding": normal(cfg.max_z, H),
        "rbf": rbf_init(cfg, dtype),
        "neighbor_embedding": {
            "embedding": normal(cfg.max_z, H),
            "distance_proj": lin(R, H),
            "combine": lin(2 * H, H),
        },
        "edge_embedding": {"edge_proj": lin(R, H)},
        "layers": [],
        "out_norm": {"scale": torch.ones(H, dtype=dtype), "bias": torch.zeros(H, dtype=dtype)},
        "vec_out_norm": {"weight": torch.ones(H, dtype=dtype)},
        "output": {
            "block0": _geb_init(g, H, H // 2, dtype),
            "block1": _geb_init(g, H // 2, 1, dtype),
        },
        "atomref": torch.zeros((cfg.max_z, 1), dtype=dtype),
        "mean": torch.zeros((), dtype=dtype),
        "std": torch.ones((), dtype=dtype),
    }
    for layer in range(cfg.num_layers):
        lp = {
            "layernorm": {"scale": torch.ones(H, dtype=dtype), "bias": torch.zeros(H, dtype=dtype)},
            "vec_layernorm": {"weight": torch.ones(H, dtype=dtype)},
            "vec_proj": lin(H, 3 * H, bias=False),
            "q_proj": lin(H, H),
            "k_proj": lin(H, H),
            "v_proj": lin(H, H),
            "dk_proj": lin(H, H),
            "dv_proj": lin(H, H),
            "s_proj": lin(H, 2 * H),
            "o_proj": lin(H, 3 * H),
        }
        if layer != cfg.num_layers - 1:
            lp["f_proj"] = lin(H, H)
            lp["w_src_proj"] = lin(H, H, bias=False)
            lp["w_trg_proj"] = lin(H, H, bias=False)
        p["layers"].append(lp)
    return p


def flatten(tree, prefix=()) -> list[tuple[tuple, torch.Tensor]]:
    """[(path, leaf)] in a fixed order; list positions appear as ints."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [leaf for k, v in items for leaf in flatten(v, prefix + (k,))]


def unflatten(leaves: list[tuple[tuple, torch.Tensor]]) -> dict:
    """Inverse of ``flatten``."""
    root: dict = {}
    for path, leaf in leaves:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
