"""The serving heads' first layer after its products, through the hand-written
CUDA kernel of ``csrc/heads_epilogue.cu``.

The serving route of the pose heads (``models/heads.py::FirstLayers``) multiplies
each backbone map at its own resolution, for the three heads at once, into fp32
products P0 (B, N, C), P1 (B, N1, C) and P2 (B, N2, C), C = 3 * 1024.
``heads_epilogue`` forms from them, per point (b, n) and column c,

    P0[b, n, c] + P1[b, up_1[b, n], c] + P2[b, up_2[b, n], c] + wcat[cat_id[b], c]
    (+ wxyz[:, c'] . xyz[b, n] on the last 1024 columns, the translation head's)
    + bias[c],

then each head's eval BatchNorm and ReLU, in the tier of ``xyz``: fp32, or bf16
with the sum and the bf16 bias rounded to bf16 once, as ``F.linear`` on bf16
operands rounds a product and its bias, and the BatchNorm formed in fp32 and
rounded once (the kernel's source gives the order of every rounding).
``params`` (5, C) holds the bias, the BatchNorm's mean, its den =
sqrt(var + eps) (fp32) or scale = rsqrt(var + eps) * gamma (bf16), gamma
(fp32; unused in bf16) and beta; ``build_params`` makes it.

``out``, when given, receives h: in fp32 it may be P0 itself (each element
of P0 is read before the same element of h is written, by the same thread),
which saves the serving route a (B, N, C) fp32 buffer, 1.2 GB at B = 96.

On CPU tensors the wrapper runs ``heads_epilogue_plain``, the same arithmetic
in the same order; on CUDA tensors it launches the kernel or raises.  It
counts fp32 launches in ``heads_epilogue.launches`` and bf16 ones in
``.bf16_launches``.  No TPU kernel corresponds: the JAX package's heads
multiply the concatenated feature.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build

HEAD_COLS = 1024  # one head's columns; the kernel's block covers one head


def build_params(bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """The epilogue's (5, C) fp32 constants from the first layer's bias and its
    BatchNorm's running statistics and affine parameters, for the tier
    ``dtype``: bf16 rounds the bias and folds gamma into the scale, as
    ``models/face_recon.py::batch_norm`` forms it in eval mode."""
    if dtype == torch.bfloat16:
        scale = torch.rsqrt(var + eps) * gamma
        rows = (bias.to(dtype).float(), mean, scale, torch.ones_like(scale), beta)
    else:
        rows = (bias, mean, torch.sqrt(var + eps), gamma, beta)
    return torch.stack([r.float() for r in rows])


def heads_epilogue_plain(p0, p1, p2, up_1, up_2, cat_id, xyz, wcat, wxyz,
                         params) -> torch.Tensor:
    """The epilogue in plain PyTorch: every add, product and rounding of the
    kernel, in its order.  Raises on a category outside [0, obj_c)."""
    B, N, C = p0.shape
    rows = torch.arange(B, device=p0.device)[:, None]
    s = p0 + p1[rows, up_1.long()]
    s = s + p2[rows, up_2.long()]
    s = s + wcat[cat_id.long()][:, None, :]
    ts = C - wxyz.shape[1]
    x = xyz.float()
    s[..., ts:] = s[..., ts:] + ((x[..., 0:1] * wxyz[0] + x[..., 1:2] * wxyz[1])
                                 + x[..., 2:3] * wxyz[2])
    bias, mean, den, gamma, beta = params
    if xyz.dtype == torch.bfloat16:
        t = (s + bias).to(torch.bfloat16).float()
        return torch.relu((t - mean) * den + beta).to(torch.bfloat16)
    return torch.relu((s + bias - mean) / den * gamma + beta)


def heads_epilogue(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   up_1: torch.Tensor, up_2: torch.Tensor, cat_id: torch.Tensor,
                   xyz: torch.Tensor, wcat: torch.Tensor, wxyz: torch.Tensor,
                   params: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """h (B, N, C) in xyz's dtype from p0 (B, N, C), p1 (B, N1, C), p2 (B, N2, C)
    fp32, up_1 / up_2 (B, N) int32 row indices into p1 / p2, cat_id (B,) int32
    or int64, xyz (B, N, 3) fp32 or bf16, wcat (obj_c, C), wxyz (3, 1024) for
    the last 1024 columns and params (5, C), fp32; written into ``out`` when
    given, which shares memory with no input but p0 (module docstring)."""
    f32 = torch.float32
    _build.check(p0, "p0", f32, (None, None, None))
    B, N, C = p0.shape
    if out is not None:
        _build.check(out, "out", xyz.dtype, (B, N, C))
    if _build.on_cpu(p0, p1, p2, up_1, up_2, cat_id, xyz, wcat, wxyz, params,
                     *([] if out is None else [out])):
        h = heads_epilogue_plain(p0, p1, p2, up_1, up_2, cat_id, xyz, wcat, wxyz, params)
        return h if out is None else out.copy_(h)
    fast = xyz.dtype == torch.bfloat16
    if C % HEAD_COLS:
        raise ValueError(f"heads_epilogue: C={C} is not a multiple of {HEAD_COLS}")
    _build.check(p1, "p1", f32, (B, None, C))
    _build.check(p2, "p2", f32, (B, None, C))
    _build.check(up_1, "up_1", torch.int32, (B, N))
    _build.check(up_2, "up_2", torch.int32, (B, N))
    if cat_id.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cat_id: expected int32 or int64, got {cat_id.dtype}")
    _build.check(cat_id, "cat_id", cat_id.dtype, (B,))
    _build.check(xyz, "xyz", torch.bfloat16 if fast else f32, (B, N, 3))
    _build.check(wcat, "wcat", f32, (None, C))
    _build.check(wxyz, "wxyz", f32, (3, HEAD_COLS))
    _build.check(params, "params", f32, (5, C))
    if out is None:
        out = torch.empty((B, N, C), dtype=xyz.dtype, device=p0.device)
    _build.launch("hs_heads_epilogue", p0, p1, p2, up_1, up_2, cat_id,
                  int(cat_id.dtype == torch.int64), xyz, wcat, wxyz, params, out, B, N,
                  p1.shape[1], p2.shape[1], C, wcat.shape[0], int(fast))
    if fast:
        heads_epilogue.bf16_launches += 1
    else:
        heads_epilogue.launches += 1
    return out


heads_epilogue.launches = 0  # fp32 launches
heads_epilogue.bf16_launches = 0
