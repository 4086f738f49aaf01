"""The edge kernels' products in each mode, in plain PyTorch.

Every kernel product (``mma_rows_times_cols`` in K1, K2, K7 and K8,
``row_tile`` in K3/K8's g_edge and in K5/K6, ``csrc/common.cuh``) takes
the same split: each float32 operand x is
cut into hi = tf32(x) and lo = tf32(x - hi), rounded as
``cvt.rna.tf32.f32`` does (to 10 explicit mantissa bits, ties away from
zero), and x @ w becomes lo_x @ hi_w + hi_x @ lo_w + hi_x @ hi_w with
float32 sums.  ``mm_tf32x3_plain`` is that arithmetic on the CPU (or the
card), so tests can bound the split's error.  The kernels' other modes
(``_build.MM_MODE``) have theirs: ``mm_highest_plain`` (the product in
float64, rounded once to float32: the kernels' float32 FMA chains are
within a float32 product's error of it) and ``mm_bf16_plain`` (both
operands rounded to bfloat16, round to nearest even as ``x.astype(bf16)``
does, then a float32 product: the product of two bfloat16 values is exact
in float32, so this is the TPU's single pass).  ``plain_mm(mode)`` gives the
mode's product; chip_smoke.py holds each mode's kernels to it, and the
wrappers' plain route takes it in ``highest`` and ``default``.  Both pass
float64 operands (the reference runs) to the exact product.
``mm_tf32x3`` runs the helper alone on the card (``csrc/tf32x3_mm.cu``)
from the current mode's library, and the mode's model on the CPU.  The
model's path calls none of them.
"""

from __future__ import annotations

import torch

from ai2bmd_torch.ops import LAUNCHES, _build

_SIGN = -0x80000000
_ABS = 0x7FFFFFFF


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 values: the nearest value with 10
    explicit mantissa bits, ties away from zero, as float32 with the low 13
    bits 0.  Subnormals round the same way (a carry may make them normal),
    values past the largest TF32 round to infinity, inf and NaN pass."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & _ABS) + 0x1000) & ~0x1FFF
    out = (mag | (bits & _SIGN)).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32 values, with x = hi + lo to ~2^-22 |x|."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def mm_tf32x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the kernels take it: lo_x hi_w + hi_x lo_w + hi_x hi_w, float32."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    return xl @ wh + xh @ wl + xh @ wh


def mm_highest_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the ``highest`` kernels take it: full float32, modelled by the
    float64 product rounded once (whatever torch's float32 matmul precision
    is set to)."""
    if x.dtype == torch.float64:
        return x @ w
    return (x.double() @ w.double()).to(x.dtype)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rn.bf16.f32`` widened back: the nearest bfloat16 value, ties to
    even, as float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def mm_bf16_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the ``default`` kernels take it: one pass on operands rounded
    to bfloat16, float32 sums."""
    if x.dtype == torch.float64:
        return x @ w
    return round_bf16(x) @ round_bf16(w)


PLAIN_MM = {"b3": mm_tf32x3_plain, "highest": mm_highest_plain, "default": mm_bf16_plain}


def plain_mm(mode: str | None = None):
    """The plain product of a mode (None: the current one, ``_build.MM_MODE``)."""
    return PLAIN_MM[mode or _build.MM_MODE]


def mm_tf32x3(x: torch.Tensor, w: torch.Tensor, rows: int = 40) -> torch.Tensor:
    """x [M, K] @ w [K, N] through the tensor-core helper alone, from the
    current mode's library, ``rows`` rows a block (M % rows == 0, rows a
    multiple of 8 up to 48, K % 32 == 0, N a multiple of 256 or N <= 256 and
    N % 32 == 0); the mode's plain model for CPU tensors."""
    if x.device.type == "cpu":
        return plain_mm()(x, w)
    M, K = x.shape
    N = w.shape[1]
    _build.check("x", x, (M, K), device=x.device)
    _build.check("w", w, (K, N), device=x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _build.call("tf32x3_mm_launch", [_build.P] * 3 + [_build.I] * 4,
                _build.ptr(x), _build.ptr(w), _build.ptr(out), M, K, N, rows)
    LAUNCHES["tf32x3_mm"] += 1
    return out
