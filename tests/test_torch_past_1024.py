"""Port parity past 1,024 channels (ai2bmd_torch vs ai2bmd_tpu), on the CPU.

The edge kernels K1-K3, K7, K8 and the full-layer kernels K5/K6 take every
H whose head count divides it, as the JAX package's Pallas kernels do: no
constant bounds H.  On the CPU the wrappers run their plain versions; these
tests hold them past 1,024 channels against the Pallas kernels in interpret
mode, as tests/test_torch_wide_heads.py and test_torch_wide_layer.py hold
them at narrower widths (their checks, at these widths): the edge core and
its VJP and K7/K8's plain versions at H = 1,064 with 8 heads of 133
channels (H % 32 != 0: the kernels' padded route), K5/K6's plain versions
at H = 1,280 with 8 heads of 160; and a 2-layer model of 1,280 channels on
Chignolin's ACE-NME batch against the JAX package's model.  The same
inputs, made with numpy from a seed, go through both packages in float32.
"""

import dataclasses

import jax
import numpy as np
import pytest

from ai2bmd_tpu.models import visnet as JV
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import vismp as TK
from test_torch_wide_heads import T, check_edge_core, check_recompute
from test_torch_wide_heads import chig_batches  # noqa: F401  (the module-scoped fixture)
from test_torch_wide_layer import LAST, check_layer

# (B, A, H, heads): 8 heads of 133 channels, H % 32 != 0
H1064 = (1, 8, 1064, 8)


def test_edge_core_and_vjp_match_pallas_past_1024(rng):
    """K1's plain version and FusedVisMP's backward (K2/K3's plain versions)
    at H = 1,064 with 8 heads of 133 channels against fused_vis_mp in
    interpret mode, values and VJP, with the edge update."""
    assert not TK.narrow_shapes(1064, 8) and TK.layer_shapes(1064, 8, 8)
    check_edge_core(rng, H1064)


def test_recompute_backward_matches_pallas_past_1024(rng):
    """K7's and K8's plain versions at H = 1,064 with 8 heads of 133
    channels against ``_bwd_msg_call`` and ``_bwd_upd_call`` in interpret
    mode."""
    check_recompute(rng, H1064)


@pytest.mark.parametrize(**LAST)
def test_layer_matches_pallas_past_1024(rng, last):
    """K5's plain version and K6's through FusedLayer at H = 1,280 with 8
    heads of 160 channels against the Pallas full-layer kernels in
    interpret mode, forward and VJP, on padded weights too (bit for bit the
    unpadded result)."""
    check_layer(rng, 1280, 8, last)


MODEL = dict(hidden_channels=1280, num_heads=8, num_layers=2, num_rbf=8, max_z=20)


def test_model_past_1024_matches_jax(chig_batches):  # noqa: F811
    """E and F of a 2 x 1,280 model with 8 heads of 160 channels on
    Chignolin's ACE-NME batch (9 x 16) against the JAX package's model
    within 1e-4 eV and eV/A: the port's plain path, its remat route
    (FusedVisMP through K1 without a stash and K7/K8's plain versions) and
    its full-layer route (K5/K6's plain versions), the routes the card
    takes at this width."""
    jcfg = JV.ViSNetConfig(**MODEL)
    jparams = JV.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    z, pos, mask = chig_batches[1]
    e_j, f_j = jax.jit(lambda p, z, x, m: JV.energy_and_forces(p, z, x, m, jcfg))(
        jparams, z, pos, mask)
    cfg = TV.ViSNetConfig(**MODEL)
    for c in (cfg, dataclasses.replace(cfg, remat=True),
              dataclasses.replace(cfg, fused_layer=True)):
        e_t, f_t = TV.energy_and_forces(tparams, T(z).long(), T(pos), T(mask), c)
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)
