"""The products' modes and --matmul-precision (ai2bmd_torch against ai2bmd_tpu).

The JAX package's kernels read ``AI2BMD_KERNEL_MM_PRECISION``
(``ai2bmd_tpu/ops/pallas/vismp.py:43-70``): ``b3`` (three bf16 passes),
``highest`` (full float32) or ``default`` (one bf16 pass).  The port reads
the same variable into ``ops._build.MM_MODE`` and launches each mode's own
kernel library on the card; on the CPU the wrappers of ``highest`` and
``default`` take their mode's plain product (``ops/tf32x3.py``).  Here, on
the CPU: the values and the error message against JAX's; each mode's plain
product against JAX's; one edge-core call and one full-layer call, values
and VJP, under ``highest`` and ``default`` against JAX's Pallas kernels in
interpret mode with JAX's mode patched in (``default`` as the TPU's single
pass, from ``_split_b16``'s hi half: on the CPU JAX's DEFAULT precision is
float32); the per-mode launch count and library, and a failed build or
launch naming its mode; ``--matmul-precision`` on every rank of a gloo
world, and without a card.  Inputs are made with numpy from a seed.
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
import torch_mesh_ranks as MR
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.ops.pallas import vislayer as JL
from ai2bmd_tpu.ops.pallas import vismp as JK
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import LAUNCHES, _build
from ai2bmd_torch.ops import tf32x3 as TT
from ai2bmd_torch.ops import vislayer as TL
from ai2bmd_torch.ops import vismp as TK
from ai2bmd_torch.parallel.launch import launch
from ai2bmd_torch.utils import device as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, A, H, NH, S = 2, 16, 32, 4, 8
CUTOFF = 5.0
LAYER_CFG = JV.ViSNetConfig(hidden_channels=H, num_heads=NH, num_layers=2)
T = lambda a: torch.as_tensor(np.array(a))
# Tolerances, times max(1, max|ref|), against JAX:
# - products of float32 operands in another order: a few float32 roundings
#   of K = 256 terms
PRODUCT_TOL = 1e-6
# - the two b3 splits: JAX's bf16 halves drop ~2^-16 of each term, the
#   port's TF32 halves ~2^-21 (tests/test_torch_tf32x3.py)
B3_TOL = 1e-4
# - highest through the edge core and the layer: float32 sums taken in
#   other orders along chains of products
HIGHEST_TOL = 2e-5
# - default: every product rounds its operands to bfloat16, so an
#   intermediate the two packages compute a float32 rounding apart can round
#   to neighbouring bfloat16 values, one step of 2^-8 of that operand.  The
#   port sums heads unrounded where JAX's default rounds them (ROADMAP.md,
#   Queue 3), a difference of the same order as the rounding's own in
#   x_agg; chip_smoke.py holds the kernels to the port's own plain model,
#   which shares their semantics, more tightly (default_misses)
DEFAULT_TOL = 2.0 ** -8


@pytest.fixture(autouse=True)
def restore_precision():
    """Put back the process-wide matmul precision, the chosen
    --matmul-precision and the kernels' mode after each test: an xdist
    worker runs many files, and torch's CPU matmul takes "medium" as
    bfloat16 where the CPU has bfloat16 instructions."""
    saved = (torch.get_float32_matmul_precision(), D.chosen_matmul_precision(),
             torch.backends.cudnn.allow_tf32, _build.MM_MODE)
    yield
    torch.set_float32_matmul_precision(saved[0])
    D._chosen = saved[1]
    torch.backends.cudnn.allow_tf32 = saved[2]
    _build.MM_MODE = saved[3]


def _set_mode(monkeypatch, value):
    monkeypatch.setenv(TK.MM_ENV, value)
    return TK.configure_mm_mode()


# ---------------------------------------------------------------------------
# the mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["b3", "highest", "high", "", "default"])
def test_each_value_maps_as_the_jax_kernels_run_it(monkeypatch, value):
    """b3 splits only under "b3" in JAX's code (vismp.py:93, :607); "high"
    and "" run one dot at precision None, full float32 (its comment calls
    "high" an alias of b3); "default" one DEFAULT pass."""
    assert set(TK.MM_MODES) == set(JK._PREC_MODES)
    prec = JK._PREC_MODES[value]
    want = ("b3" if value == "b3" else
            "default" if prec == jax.lax.Precision.DEFAULT else "highest")
    assert prec in (None, jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT)
    assert _set_mode(monkeypatch, value) == want == _build.MM_MODE
    monkeypatch.delenv(TK.MM_ENV)
    assert TK.configure_mm_mode() == "b3"     # unset, as JAX's default "b3"


def test_an_unknown_mode_raises_the_jax_message(monkeypatch):
    """JAX raises at import; the port when it reads the variable."""
    env = dict(os.environ, **{TK.MM_ENV: "bf16x9", "JAX_PLATFORMS": "cpu"})
    run = subprocess.run([sys.executable, "-c", "import ai2bmd_tpu.ops.pallas.vismp"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    jax_msg = run.stderr.strip().splitlines()[-1]
    assert jax_msg.startswith("ValueError: ")
    monkeypatch.setenv(TK.MM_ENV, "bf16x9")
    with pytest.raises(ValueError) as exc:
        TK.configure_mm_mode()
    assert str(exc.value) == jax_msg[len("ValueError: "):]


# ---------------------------------------------------------------------------
# each mode's plain product against JAX's
# ---------------------------------------------------------------------------

def _operands(seed=0, rows=256, K=256, N=64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, K)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((K, N)) * (2.0 / (K + N)) ** 0.5).astype(np.float32)
    return x, w


def _close(mine, ref, tol, label=""):
    mine, ref = np.asarray(mine, np.float64), np.asarray(ref, np.float64)
    assert mine.shape == ref.shape, label
    err = float(np.abs(mine - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), (label, err)


def test_b3_product_against_the_jax_split(monkeypatch):
    """The port's 3xTF32 model against JAX's 3-pass bf16 split, x @ w through
    ``_mm`` and x @ w^T through ``_dotT``, both within B3_TOL."""
    monkeypatch.setattr(JK, "_MODE", "b3")
    x, w = _operands(1)
    _close(TT.plain_mm("b3")(T(x), T(w)), JK._mm(jnp.asarray(x), jnp.asarray(w)), B3_TOL)
    wt = np.ascontiguousarray(w.T)
    _close(TT.plain_mm("b3")(T(x), T(wt).T), JK._dotT(jnp.asarray(x), jnp.asarray(wt)), B3_TOL)


def test_highest_product_against_jax_highest():
    x, w = _operands(2)
    ref = jnp.dot(jnp.asarray(x), jnp.asarray(w), precision=jax.lax.Precision.HIGHEST,
                  preferred_element_type=jnp.float32)
    _close(TT.plain_mm("highest")(T(x), T(w)), ref, PRODUCT_TOL)


def test_default_product_against_one_bf16_pass():
    """Both operands rounded as ``astype(bfloat16)`` rounds them (bit for
    bit), then a float32 product of exact bf16 products."""
    x, w = _operands(3)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for a, ja in ((x, jx), (w, jw)):
        np.testing.assert_array_equal(TT.round_bf16(T(a)).numpy(),
                                      np.asarray(ja.astype(jnp.bfloat16).astype(jnp.float32)))
    ref = jnp.dot(jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    _close(TT.plain_mm("default")(T(x), T(w)), ref, PRODUCT_TOL)


def test_float64_operands_take_the_exact_product():
    """The reference runs (float64) keep their exact products in every mode."""
    x, w = _operands(4)
    x64, w64 = T(x).double(), T(w).double()
    for mode in ("highest", "default"):
        assert torch.equal(TT.plain_mm(mode)(x64, w64), x64 @ w64), mode


# ---------------------------------------------------------------------------
# the edge core and the full layer against the Pallas kernels in a mode
# ---------------------------------------------------------------------------

def _one_pass(x, w, dims):
    """JAX's DEFAULT dot as the TPU runs it: one pass on the operands' bf16
    values, the hi halves of ``_split_b16``."""
    xh, _ = JK._split_b16(x)
    wh, _ = JK._split_b16(w)
    return jax.lax.dot_general(xh, wh, (dims, ((), ())), preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.DEFAULT)


@pytest.fixture
def jax_mode(monkeypatch, request):
    """JAX's kernels in a mode: ``highest`` through _MODE / _PREC (read when
    the kernels trace), ``default`` with JAX's products (``_mm``, ``_dotT``,
    and vislayer's imported names) patched to the TPU's single pass.  JAX's
    compile caches are cleared before and after, so that no trace of another
    mode is reused."""
    mode = request.param
    prec = {"highest": jax.lax.Precision.HIGHEST, "default": jax.lax.Precision.DEFAULT}[mode]
    monkeypatch.setattr(JK, "_MODE", mode)
    monkeypatch.setattr(JK, "_PREC", prec)
    if mode == "default":
        mm = lambda x, w: _one_pass(x, w, ((1,), (0,)))
        dot_t = lambda x, w: _one_pass(x, w, ((1,), (1,)))
        for mod in (JK, JL):
            monkeypatch.setattr(mod, "_mm", mm)
            monkeypatch.setattr(mod, "_dotT", dot_t)
    jax.clear_caches()
    yield mode
    jax.clear_caches()


EDGE_ORDER = ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist", "adj",
              "w_dkv", "b_dkv", "w_s", "b_s", "w_f", "b_f"]
EDGE_DIFF = ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist"]
LAYER_ORDER = ("x", "vec", "edge", "d_sh", "dist", "adj")


def _cases(rng):
    """An edge core's inputs (random positions, 5 A graph), a fused layer's
    (sphere-major streams, the second fragment's last 3 slots masked), their
    cotangents, and the layer's weights (2 layers x 32, 4 heads)."""
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    pos = (rng.random((B, A, 3)) * 6).astype(np.float32)
    vecp = pos[:, None, :, :] - pos[:, :, None, :]
    dist = np.sqrt((vecp ** 2).sum(-1) + 1e-12).astype(np.float32)
    edge = dict(q=f(B, A, H), k=f(B, A, H), v=f(B, A, H), vec=f(B, A, S, H), wt=f(B, A, S, H),
                wsrc=f(B, A, S, H), edge=f(B, A, A, H), d_sh=f(B, A, A, S), dist=dist,
                adj=(dist < CUTOFF).astype(np.float32), w_dkv=f(H, 2 * H) * 0.6,
                b_dkv=f(2 * H) * 0.3, w_s=f(H, 2 * H) * 0.6, b_s=f(2 * H) * 0.3,
                w_f=f(H, H) * 0.6, b_f=f(H) * 0.3)
    mask = np.ones((B, A), bool)
    mask[1, A - 3:] = False
    adj, _, ldist, d_sh = JV.dense_graph(jnp.asarray(pos), jnp.asarray(mask), LAYER_CFG)
    adj = np.asarray(adj, np.float32)
    layer = dict(x=f(B, A, H) * 1.6, vec=f(B, S, A, H),
                 edge=(f(B, A, A, H) * 0.7) * adj[..., None],
                 d_sh=np.ascontiguousarray(np.transpose(np.asarray(d_sh), (0, 3, 1, 2))),
                 dist=np.asarray(ldist), adj=adj)
    jparams = JV.init_params(jax.random.PRNGKey(0), LAYER_CFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jw = JL.layer_weights(jparams["layers"][0], H, NH, False)
    tw = TL.layer_weights(tparams["layers"][0], H, NH, False)
    return edge, layer, jw, tw


@pytest.mark.parametrize("jax_mode", ["highest", "default"], indirect=True)
def test_edge_core_and_layer_match_pallas_in_the_mode(monkeypatch, rng, jax_mode):
    """The edge core (K1's plain route, then K2/K3's through FusedVisMP) and
    the full layer (K5/K6's through FusedLayer) on the CPU in the port's
    mode, values and VJP, against fused_vis_mp and fused_layer in interpret
    mode in JAX's, traced in one jit.  Tolerance HIGHEST_TOL or DEFAULT_TOL.
    In default, JAX's kernels also round the head sums' operands, which they
    take as products with a 0/1 pooling matrix; the port sums heads in
    float32 in every mode (ROADMAP.md, Queue 3), which the tolerance covers
    (5.7e-5 of the scale at this size)."""
    mode = jax_mode
    assert _set_mode(monkeypatch, mode) == mode
    edge, layer, jw, tw = _cases(rng)
    core = JK.fused_vis_mp(CUTOFF, NH, False, interpret=True)
    jlayer = JL.fused_layer(CUTOFF, NH, False, interpret=True)
    e_cts = [rng.standard_normal(s).astype(np.float32) for s in
             ((B, A, H), (B, A, S, H), (B, A, A, H))]
    l_cts = [rng.standard_normal(layer[n].shape).astype(np.float32) for n in ("x", "vec", "edge")]

    @jax.jit
    def pallas(e_ins, l_ins, e_cts, l_cts):
        e_out, e_vjp = jax.vjp(core, *e_ins)
        l_out, l_vjp = jax.vjp(lambda *i: jlayer(*i, jnp.asarray(layer["adj"]), *jw), *l_ins)
        return e_out, e_vjp(e_cts), l_out, l_vjp(l_cts)

    e_out_j, e_grad_j, l_out_j, l_grad_j = pallas(
        tuple(jnp.asarray(edge[n]) for n in EDGE_ORDER),
        tuple(jnp.asarray(layer[n]) for n in LAYER_ORDER[:5]),
        tuple(map(jnp.asarray, e_cts)), tuple(map(jnp.asarray, l_cts)))
    tol = {"highest": HIGHEST_TOL, "default": DEFAULT_TOL}[mode]

    t = {n: T(edge[n]).requires_grad_(n in EDGE_DIFF) for n in EDGE_ORDER}
    e_out = TK.FusedVisMP.apply(*[t[n] for n in EDGE_ORDER], CUTOFF, NH)
    e_grad = torch.autograd.grad(e_out, [t[n] for n in EDGE_DIFF], [T(c) for c in e_cts])
    for name, mine, ref in zip(("x_agg", "vec_agg", "df"), e_out, e_out_j):
        _close(mine.detach(), ref, tol, f"edge {name}")
    for name, mine, ref in zip(EDGE_DIFF, e_grad, e_grad_j):
        _close(mine, ref, tol, f"edge g_{name}")

    ins = [T(layer[n]).requires_grad_(True) for n in LAYER_ORDER[:5]]
    l_out = TL.fused_layer(CUTOFF, NH, False)(*ins, T(layer["adj"]), *tw)
    l_grad = torch.autograd.grad(l_out, ins, [T(c) for c in l_cts])
    for name, mine, ref in zip(("x", "vec", "edge"), l_out, l_out_j):
        _close(mine.detach(), ref, tol, f"layer {name}")
    for name, mine, ref in zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"), l_grad, l_grad_j):
        _close(mine, ref, tol, f"layer {name}")

    # df passes one product (zf = edge @ W_f) and no head sum: there the
    # port's mode agrees with JAX's to float32 rounding, and the exact
    # float32 plain version parts from one bf16 pass by far more
    exact = TK.edge_fwd_plain(*[T(edge[n]) for n in ("q", "k", "v", "vec", "edge", "d_sh",
                                                     "dist", "adj", "w_dkv", "b_dkv", "w_s",
                                                     "b_s")], CUTOFF, NH, T(edge["wt"]),
                              T(edge["wsrc"]), T(edge["w_f"]), T(edge["b_f"]))[2]
    _close(e_out[2].detach(), e_out_j[2], PRODUCT_TOL, "df")
    gap = float((exact - T(e_out_j[2])).abs().max()) / max(1.0, float(np.abs(e_out_j[2]).max()))
    assert (gap > 100 * PRODUCT_TOL) == (mode == "default"), gap


# ---------------------------------------------------------------------------
# the libraries: one a mode, counted by mode, failures named
# ---------------------------------------------------------------------------

class _Lib:
    """A kernel library's stand-in: each launcher returns ``rc``."""

    def __init__(self, rc):
        self.rc = rc
        self.ai2bmd_error_string = lambda rc: b"an error"

    def __getattr__(self, name):
        fn = lambda *args: self.rc
        fn.argtypes = None
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch path on CPU tensors: route() says "kernel", the
    argument checks pass, and ``_build.library(mode)`` hands out a stand-in
    library, recording the modes asked for."""
    asked = []
    libs = {}

    def library(mode="b3"):
        asked.append(mode)
        return libs.setdefault(mode, _Lib(0))

    monkeypatch.setattr(TK, "route", lambda t, kernels="edge-core": True)
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", library)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "LIBRARY_LAUNCHES", {})
    saved = dict(LAUNCHES)
    yield asked, libs
    LAUNCHES.update(saved)


def _edge_fwd_once(rng):
    f = lambda *s: T((rng.standard_normal(s) * 0.3).astype(np.float32))
    q, vec, e = f(1, 8, H), f(1, 8, S, H), f(1, 8, 8, H)
    return TK.edge_fwd(q, q, q, vec, e, f(1, 8, 8, S), f(1, 8, 8), f(1, 8, 8), f(H, 2 * H),
                       f(2 * H), f(H, 2 * H), f(2 * H), CUTOFF, NH)


@pytest.mark.parametrize("value, mode", [("b3", "b3"), ("high", "highest"),
                                         ("default", "default")])
def test_a_launch_takes_its_modes_library_and_counts_under_it(monkeypatch, fake_card, rng,
                                                              value, mode):
    asked, _ = fake_card
    _set_mode(monkeypatch, value)
    before = LAUNCHES["edge_fwd"]
    _edge_fwd_once(rng)
    assert asked == [mode]
    assert LAUNCHES["edge_fwd"] == before + 1
    assert _build.LIBRARY_LAUNCHES == {mode: 1}


def test_a_failed_launch_names_its_mode(monkeypatch, fake_card, rng):
    _, libs = fake_card
    _set_mode(monkeypatch, "default")
    libs["default"] = _Lib(700)
    with pytest.raises(RuntimeError, match=r"edge_fwd_launch \(default library\) failed"):
        _edge_fwd_once(rng)
    assert "b3" not in libs      # no other mode's library was asked for


def test_a_failed_build_names_its_mode_and_runs_no_other(monkeypatch, tmp_path):
    """nvcc (here a compiler that always fails) refuses the highest library:
    the build raises naming the mode, and no library is loaded in its place.
    An unknown mode has no library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc failed to build the 'highest' kernel library"):
        _build.library("highest")
    assert _build._libs == {} and not list(tmp_path.glob("*.so"))
    with pytest.raises(ValueError, match="no kernel library for product mode 'high'"):
        _build.build("high")


# ---------------------------------------------------------------------------
# --matmul-precision
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def precision_world():
    """A gloo world of two ranks, spawned after this process chose
    --matmul-precision bfloat16 (as the CLI does) with the kernels' variable
    at "default": what each rank reports (torch_mesh_ranks.precision_of_a_rank)."""
    saved = (torch.get_float32_matmul_precision(), D.chosen_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(TK.MM_ENV, "default")
        try:
            D.set_matmul_precision("bfloat16")
            return launch(MR.precision_of_a_rank, 2, "cpu", timeout_s=MR.WORLD_S)
        finally:
            torch.set_float32_matmul_precision(saved[0])
            D._chosen = saved[1]
            torch.backends.cudnn.allow_tf32 = saved[2]


def test_every_rank_takes_the_chosen_precision_and_the_mode(precision_world):
    x = torch.linspace(-1.0, 1.0, 64).reshape(8, 8) / 3.0
    for r, got in enumerate(precision_world):
        assert got["rank"] == r
        assert got["torch"] == "medium" and got["chosen"] == "bfloat16"
        assert got["mode"] == "default"
        np.testing.assert_array_equal(got["product"], TT.mm_bf16_plain(x, x.T).numpy())


@pytest.mark.parametrize("value, torch_name", [("float32", "highest"),
                                               ("tensorfloat32", "high"),
                                               ("bfloat16", "medium")])
def test_set_matmul_precision_sticks_through_require_cuda(monkeypatch, value, torch_name):
    """The chosen precision survives the card's own setting: require_cuda
    (every entry point) no longer resets TF32 once a precision is chosen."""
    assert D.set_matmul_precision(value) == torch_name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    D.require_cuda()
    assert torch.get_float32_matmul_precision() == torch_name
    assert torch.backends.cudnn.allow_tf32 == (value != "float32")
    D._chosen = None                  # none chosen: require_cuda pins float32
    D.require_cuda()
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_bfloat16_without_a_card_raises_the_require_cuda_message(monkeypatch, tmp_path):
    """--matmul-precision bfloat16 without --device cpu and without a card:
    the CLI stops with require_cuda's error, never runs on the CPU."""
    conftest.require_examples()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        TCLI.main(["--prot-file", conftest.example_pdb("chig"), "--log-dir", str(tmp_path),
                   "--model-preset", "tiny", "--matmul-precision", "bfloat16"])
    assert torch.get_float32_matmul_precision() == "medium"
