"""The 3xTF32 split of the edge kernels' tensor-core products, in plain PyTorch.

Every kernel product (``mma_rows_times_cols`` in K1, K2, K7 and K8,
``row_tile`` in K3/K8's g_edge and in K5/K6, ``csrc/common.cuh``) takes
the same split: each float32 operand x is
cut into hi = tf32(x) and lo = tf32(x - hi), rounded as
``cvt.rna.tf32.f32`` does (to 10 explicit mantissa bits, ties away from
zero), and x @ w becomes lo_x @ hi_w + hi_x @ lo_w + hi_x @ hi_w with
float32 sums.  ``mm_tf32x3_plain`` is that arithmetic on the CPU (or the
card), so tests can bound the split's error; ``mm_tf32x3`` runs the helper
alone on the card (``csrc/tf32x3_mm.cu``) and this model on the CPU.  The
model's path calls neither.
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


def mm_tf32x3(x: torch.Tensor, w: torch.Tensor, rows: int = 40) -> torch.Tensor:
    """x [M, K] @ w [K, N] through the tensor-core helper alone, ``rows``
    rows a block (M % rows == 0, rows a multiple of 8 up to 48, K % 32 == 0,
    N a multiple of 256 or N <= 256 and N % 32 == 0); the plain model for
    CPU tensors."""
    if x.device.type == "cpu":
        return mm_tf32x3_plain(x, w)
    M, K = x.shape
    N = w.shape[1]
    _build.check("x", x, (M, K), device=x.device)
    _build.check("w", w, (K, N), device=x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _build.call("tf32x3_mm_launch", [_build.P] * 3 + [_build.I] * 4,
                _build.ptr(x), _build.ptr(w), _build.ptr(out), M, K, N, rows)
    LAUNCHES["tf32x3_mm"] += 1
    return out
