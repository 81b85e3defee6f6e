"""Differentiable HS reductions of the training path, through hand-written
CUDA kernels.

Counterpart of ``hspose_tpu/ops/pallas_hs.py``: ``hs_surface_reduce`` and
``hs_support_reduce(..., bwd_store=True or False)``, the v3 contract on
pre-gathered rows, with the TPU-only arguments (``tq``, ``exact``,
``kmajor``, ``theta_mxu``, ``bwd_exact``, ``interpret``) gone.  Layouts are
(B, N, K, .).

Five kernels, each behind a wrapper that runs its plain version (in this
module) on CPU tensors and launches the kernel on CUDA tensors or raises:

* ``hs_surface_fwd`` (K12) and ``hs_surface_bwd`` (K15) ->
  ``csrc/hs_surface_train.cu``;
* ``hs_support_fwd`` (K11), ``hs_support_bwd`` (K13) and
  ``hs_support_bwd_recompute`` (K14) -> ``csrc/hs_support_train.cu``.

The forwards record, per (point, output column), the first k that reaches
the max (``win``) and, for the support reduction with ``store`` (the JAX
package's ``bwd_store=True``, its default), theta and the projection there
(``twin``, ``pwin``); the backwards route each cotangent to that k only.
``torch.amax`` would split a gradient over ties instead.  Without ``store``
the forward writes ``win`` only and K14 recomputes theta and the projection
at the winner, with the forward's arithmetic, before routing as K13 does,
in both tiers.  The two ``autograd.Function``s,
``HSSurfaceReduce`` and ``HSSupportReduce``, pair each forward with its
backward.  ``win`` is int32.

The rows g are a gather of a feature map by the neighbour index
(``models/layers.py``), so K11 on the card projects the source rows once and
gathers the projections: it reads ``feat`` and ``idx`` (g = feat[idx]),
which the caller passes beside g, and not g; the backwards read g.  Each
gathered row's projection keeps its bits, since both are the same fused
multiply-add chain over the input channels.

Inputs are fp32, or, for the bf16 train step (the TPU kernels'
``exact=False``), bf16 g, rf and dirs with W and b in fp32.  The bf16
calls launch the same kernels instantiated for bf16 operands; their
products round each operand to bf16 and sum in fp32, as the TPU's one-pass
products do, and their plain versions make the same roundings.  Outputs,
winner values, dW and db are fp32; dg, drf and dd come back in their
inputs' dtype, as the JAX custom VJPs cast them (pallas_hs.py:612-613,
:734).  Each wrapper counts fp32 launches in ``.launches`` and bf16 ones in
``.bf16_launches``; ``hs_support_fwd`` counts its launches without
``store`` in ``.novals_launches`` and ``.novals_bf16_launches``.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build
from hspose_tpu_torch.ops.cuda_hs_fused import (
    _bf16,
    _count,
    _empty,
    _first_max,
    _onehot,
    _per_support,
    _theta_fast,
)


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def _theta(rf: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """relu(rf . d): (B, N, K, 3), (3, C) -> (B, N, K, C) fp32.  bf16 operands
    (the bf16 tier) take ``_theta_fast``'s exact products in x, y, z order."""
    if rf.dtype == torch.bfloat16:
        return _theta_fast(rf.float(), d.float())
    return torch.relu(rf @ d)


def _operand(x: torch.Tensor, fast: bool) -> torch.Tensor:
    """x as an operand of the bf16 tier's products (rounded to bf16, as
    fp32), else x."""
    return _bf16(x) if fast else x


def hs_surface_fwd_plain(rf: torch.Tensor, dirs: torch.Tensor, support_num: int,
                         out_channel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean_s max_k relu(rf . dir_s), win): rf (B, N, K, 3), dirs (3, S*Co),
    fp32 or bf16 -> fp32 (B, N, Co), int32 (B, N, S*Co)."""
    total, wins = 0.0, []
    for s in range(support_num):
        d = dirs[:, s * out_channel:(s + 1) * out_channel]
        m, w = _first_max(_theta(rf, d))
        total = total + m
        wins.append(w)
    return total / support_num, torch.cat(wins, -1).to(torch.int32)


def hs_surface_bwd_plain(rf: torch.Tensor, dirs: torch.Tensor, win: torch.Tensor,
                         gb: torch.Tensor, support_num: int,
                         out_channel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangents (drf, dd) of ``hs_surface_fwd_plain`` for the output
    cotangent gb (B, N, Co), routed to the recorded winners where theta > 0,
    in the dtypes of rf and dirs.  bf16 inputs: the routed cotangent du is
    rounded to bf16 for both products, as the TPU kernel's one-pass
    products round it (pallas_hs.py:428-440, ``exact=False``)."""
    co, K = out_channel, rf.shape[2]
    fast = rf.dtype == torch.bfloat16
    rf32, d32 = rf.float(), dirs.float()
    g = _per_support(gb, support_num, fast)
    drf = torch.zeros(rf.shape, dtype=torch.float32, device=rf.device)
    dd = torch.zeros(dirs.shape, dtype=torch.float32, device=rf.device)
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        d = d32[:, cols]
        theta = _theta(rf, dirs[:, cols])  # the gate theta > 0 is the same as before relu
        du = torch.where(theta > 0, _onehot(win[..., cols], K) * g[:, :, None, :], 0.0)
        du = _operand(du, fast)
        drf = drf + du @ d.t()
        dd[:, cols] = rf32.reshape(-1, 3).t() @ du.reshape(-1, co)
    return drf.to(rf.dtype), dd.to(dirs.dtype)


def hs_support_fwd_plain(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, dirs: torch.Tensor, support_num: int,
                         out_channel: int):
    """(out, win, twin, pwin) of mean_s max_k relu(rf . dir_s) * (g @ W_s + b_s):
    g (B, N, K, Cin), rf (B, N, K, 3), w (Cin, S*Co), b (S*Co,), dirs (3, S*Co)
    -> (B, N, Co), int32 (B, N, S*Co), (B, N, S*Co), (B, N, S*Co), fp32.

    bf16 g, rf and dirs (with w and b fp32) are the bf16 tier: W is rounded
    to bf16 in the product, which sums in fp32, and b is added in fp32
    (pallas_hs.py:192-196, ``exact=False``)."""
    co = out_channel
    fast = g.dtype == torch.bfloat16
    total, wins, twins, pwins = 0.0, [], [], []
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        theta = _theta(rf, dirs[:, cols])
        proj = g.float() @ _operand(w[:, cols], fast) + b[cols]
        m, win = _first_max(theta * proj)
        total = total + m
        wins.append(win)
        twins.append(theta.gather(2, win[:, :, None]).squeeze(2))
        pwins.append(proj.gather(2, win[:, :, None]).squeeze(2))
    return (total / support_num, torch.cat(wins, -1).to(torch.int32),
            torch.cat(twins, -1), torch.cat(pwins, -1))


def hs_support_bwd_plain(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor,
                         dirs: torch.Tensor, win: torch.Tensor, twin: torch.Tensor,
                         pwin: torch.Tensor, gb: torch.Tensor, support_num: int,
                         out_channel: int):
    """Cotangents (dg, drf, dw, db, dd) of ``hs_support_fwd_plain`` for the
    output cotangent gb (B, N, Co), from the stored winner values
    (hspose_tpu/ops/pallas_hs.py:385-401), each in its input's dtype.

    bf16 inputs: dpi and du are formed in fp32, then each product rounds
    its operands to bf16 (dg = bf16(dpi) bf16(W)^T, drf = bf16(du) d^T,
    dW = g^T bf16(dpi), dd = rf^T bf16(du)) and sums in fp32; db sums the
    unrounded dpi."""
    co, (B, N, K, cin) = out_channel, g.shape
    fast = g.dtype == torch.bfloat16
    g32, rf32, d32 = g.float(), rf.float(), dirs.float()
    gs = _per_support(gb, support_num, fast)
    dg = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    drf = torch.zeros(rf.shape, dtype=torch.float32, device=g.device)
    dw = torch.zeros((cin, support_num * co), dtype=torch.float32, device=g.device)
    db = torch.zeros(support_num * co, dtype=torch.float32, device=g.device)
    dd = torch.zeros(dirs.shape, dtype=torch.float32, device=g.device)
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        sel = _onehot(win[..., cols], K)
        tw, pw = twin[..., cols], pwin[..., cols]
        dpi = sel * (gs * tw)[:, :, None, :]
        du = sel * torch.where(tw > 0, gs * pw, 0.0)[:, :, None, :]
        dpi_op, du_op = _operand(dpi, fast), _operand(du, fast)
        dg = dg + dpi_op @ _operand(w[:, cols], fast).t()
        drf = drf + du_op @ d32[:, cols].t()
        dw[:, cols] = g32.reshape(-1, cin).t() @ dpi_op.reshape(-1, co)
        db[cols] = dpi.sum((0, 1, 2))
        dd[:, cols] = rf32.reshape(-1, 3).t() @ du_op.reshape(-1, co)
    return dg.to(g.dtype), drf.to(rf.dtype), dw, db, dd.to(dirs.dtype)


def hs_support_bwd_recompute_plain(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor,
                                   b: torch.Tensor, dirs: torch.Tensor, win: torch.Tensor,
                                   gb: torch.Tensor, support_num: int, out_channel: int):
    """Cotangents (dg, drf, dw, db, dd) of ``hs_support_fwd_plain`` without
    stored winner values (pallas_hs.py:289-327): theta and the projection
    are recomputed as the forward forms them (in the bf16 tier with its
    roundings) and taken at the recorded winners, then routed as
    ``hs_support_bwd_plain`` routes them: dpi = [k == win] gb/S * theta,
    du = [k == win][theta > 0] gb/S * P."""
    co, fast = out_channel, g.dtype == torch.bfloat16
    twin, pwin = [], []
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        at = win[..., cols].long()[:, :, None]
        twin.append(_theta(rf, dirs[:, cols]).gather(2, at).squeeze(2))
        pwin.append((g.float() @ _operand(w[:, cols], fast) + b[cols]).gather(2, at).squeeze(2))
    return hs_support_bwd_plain(g, rf, w, dirs, win, torch.cat(twin, -1), torch.cat(pwin, -1),
                                gb, support_num, out_channel)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

def _tier(x: torch.Tensor) -> tuple[torch.dtype, int]:
    """The operand dtype of a call (fp32, or bf16 for the bf16 tier) and the
    ``fast`` flag the kernels take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected fp32 or bf16 operands, got {x.dtype}")
    return x.dtype, int(x.dtype == torch.bfloat16)


def hs_surface_fwd(rf: torch.Tensor, dirs: torch.Tensor, support_num: int,
                   out_channel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K12: see ``hs_surface_fwd_plain``."""
    if _build.on_cpu(rf, dirs):
        return hs_surface_fwd_plain(rf, dirs, support_num, out_channel)
    S, co = support_num, out_channel
    dt, fast = _tier(rf)
    _build.check(rf, "rf", dt, (None, None, None, 3))
    B, N, K, _ = rf.shape
    _build.check(dirs, "dirs", dt, (3, S * co))
    out, win = _empty((B, N, co), rf), _empty((B, N, S * co), rf, torch.int32)
    _build.launch("hs_surface_fwd", rf, dirs, out, win, B, N, K, S, co, fast)
    _count(hs_surface_fwd, fast)
    return out, win


def hs_surface_bwd(rf: torch.Tensor, dirs: torch.Tensor, win: torch.Tensor,
                   gb: torch.Tensor, support_num: int,
                   out_channel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K15: see ``hs_surface_bwd_plain``."""
    if _build.on_cpu(rf, dirs, win, gb):
        return hs_surface_bwd_plain(rf, dirs, win, gb, support_num, out_channel)
    S, co = support_num, out_channel
    dt, fast = _tier(rf)
    _build.check(rf, "rf", dt, (None, None, None, 3))
    B, N, K, _ = rf.shape
    _build.check(dirs, "dirs", dt, (3, S * co))
    _build.check(win, "win", torch.int32, (B, N, S * co))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    parts = _build.load().hs_surface_bwd_parts(B, N)
    partial = _empty((parts, 3, S * co), rf)
    drf, dd = _empty(rf.shape, rf, dt), _empty((3, S * co), rf)
    _build.launch("hs_surface_bwd", rf, dirs, win, gb, drf, partial, dd, B, N, K, S, co, fast)
    _count(hs_surface_bwd, fast)
    return drf, dd.to(dt)


def _check_support(g, rf, dirs, S, co):
    dt, fast = _tier(g)
    _build.check(g, "g", dt, (None, None, None, None))
    B, N, K, cin = g.shape
    if g.data_ptr() % 16:
        raise ValueError("g: expected a 16-byte aligned tensor")
    if _build.load().hs_support_train_supported(K, cin, co):
        raise ValueError(f"hs_support kernels do not take K={K}, Cin={cin}, Co={co} "
                         f"(1 <= K <= 32, Cin and Co multiples of 4)")
    _build.check(rf, "rf", dt, (B, N, K, 3))
    _build.check(dirs, "dirs", dt, (3, S * co))
    return B, N, K, cin, dt, fast


def hs_support_fwd(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   dirs: torch.Tensor, support_num: int, out_channel: int, store: bool = True,
                   *, feat: torch.Tensor | None = None, idx: torch.Tensor | None = None):
    """K11: see ``hs_support_fwd_plain``.  ``w`` (fp32) may be a column slice
    of the layer's (Cin, (S+1)*Co) matrix.  Without ``store`` it returns
    (out, win) and writes no winner values.

    The kernel projects the source rows and gathers: on CUDA tensors it
    reads ``feat`` (B, N, Cin, in g's dtype) and ``idx`` (B, N, K) int32,
    the rows g gathers (g = feat[idx], which the caller promises), and not g
    itself; the plain version computes from g."""
    if _build.on_cpu(g, rf, w, b, dirs):
        res = hs_support_fwd_plain(g, rf, w, b, dirs, support_num, out_channel)
        return res if store else res[:2]
    S, co = support_num, out_channel
    B, N, K, cin, dt, fast = _check_support(g, rf, dirs, S, co)
    if feat is None or idx is None:
        raise ValueError("hs_support_fwd on the card reads the source rows: pass feat "
                         "(B, N, Cin) and idx (B, N, K), the rows that g gathers")
    _build.check(feat, "feat", dt, (B, N, cin))
    _build.check(idx, "idx", torch.int32, (B, N, K))
    _build.check_rows(w, "w", (cin, S * co))
    _build.check(b, "b", torch.float32, (S * co,))
    proj = _empty((B, N, S * co), g)  # scratch: the source rows' projection
    out = _empty((B, N, co), g)
    win = _empty((B, N, S * co), g, torch.int32)
    if not store:
        _build.launch("hs_support_fwd_win", feat, idx, rf, w, w.stride(0), b, dirs, proj, out,
                      win, B, N, K, cin, S, co, fast)
        if fast:
            hs_support_fwd.novals_bf16_launches += 1
        else:
            hs_support_fwd.novals_launches += 1
        return out, win
    twin, pwin = _empty((B, N, S * co), g), _empty((B, N, S * co), g)
    _build.launch("hs_support_fwd", feat, idx, rf, w, w.stride(0), b, dirs, proj, out, win,
                  twin, pwin, B, N, K, cin, S, co, fast)
    _count(hs_support_fwd, fast)
    return out, win, twin, pwin


def hs_support_bwd(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor,
                   dirs: torch.Tensor, win: torch.Tensor, twin: torch.Tensor,
                   pwin: torch.Tensor, gb: torch.Tensor, support_num: int,
                   out_channel: int):
    """K13: see ``hs_support_bwd_plain``."""
    if _build.on_cpu(g, rf, w, dirs, win, twin, pwin, gb):
        return hs_support_bwd_plain(g, rf, w, dirs, win, twin, pwin, gb, support_num,
                                    out_channel)
    S, co = support_num, out_channel
    B, N, K, cin, dt, fast = _check_support(g, rf, dirs, S, co)
    _build.check_rows(w, "w", (cin, S * co))
    _build.check(win, "win", torch.int32, (B, N, S * co))
    _build.check(twin, "twin", torch.float32, (B, N, S * co))
    _build.check(pwin, "pwin", torch.float32, (B, N, S * co))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    parts = _build.load().hs_support_bwd_parts(B * N)
    partial = _empty((parts, cin + 4, S * co), g)
    red = _empty((cin + 4, S * co), g)
    dg, drf = _empty(g.shape, g, dt), _empty(rf.shape, g, dt)
    _build.launch("hs_support_bwd", g, rf, w, w.stride(0), dirs, win, twin, pwin, gb, dg,
                  drf, partial, red, B, N, K, cin, S, co, fast)
    _count(hs_support_bwd, fast)
    return dg, drf, red[:cin], red[cin], red[cin + 1:].to(dt)


def hs_support_bwd_recompute(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, dirs: torch.Tensor, win: torch.Tensor,
                             gb: torch.Tensor, support_num: int, out_channel: int):
    """K14: see ``hs_support_bwd_recompute_plain``."""
    if _build.on_cpu(g, rf, w, b, dirs, win, gb):
        return hs_support_bwd_recompute_plain(g, rf, w, b, dirs, win, gb, support_num,
                                              out_channel)
    S, co = support_num, out_channel
    B, N, K, cin, dt, fast = _check_support(g, rf, dirs, S, co)
    _build.check_rows(w, "w", (cin, S * co))
    _build.check(b, "b", torch.float32, (S * co,))
    _build.check(win, "win", torch.int32, (B, N, S * co))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    parts = _build.load().hs_support_bwd_parts(B * N)
    twin, pwin = _empty((B, N, S * co), g), _empty((B, N, S * co), g)  # scratch
    partial = _empty((parts, cin + 4, S * co), g)
    red = _empty((cin + 4, S * co), g)
    dg, drf = _empty(g.shape, g, dt), _empty(rf.shape, g, dt)
    _build.launch("hs_support_bwd_recompute", g, rf, w, w.stride(0), b, dirs, win, gb, twin,
                  pwin, dg, drf, partial, red, B, N, K, cin, S, co, fast)
    _count(hs_support_bwd_recompute, fast)
    return dg, drf, red[:cin], red[cin], red[cin + 1:].to(dt)


for _wrapper in (hs_surface_fwd, hs_surface_bwd, hs_support_fwd, hs_support_bwd,
                 hs_support_bwd_recompute):
    _wrapper.launches = 0  # fp32 launches
    _wrapper.bf16_launches = 0
hs_support_fwd.novals_launches = 0  # launches without store
hs_support_fwd.novals_bf16_launches = 0


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #

class HSSurfaceReduce(torch.autograd.Function):
    """mean_s max_k relu(rf . dir_s), differentiable in rf and dirs."""

    @staticmethod
    def forward(ctx, rf, dirs, support_num: int, out_channel: int):
        out, win = hs_surface_fwd(rf, dirs, support_num, out_channel)
        ctx.save_for_backward(rf, dirs, win)
        ctx.sizes = (support_num, out_channel)
        return out

    @staticmethod
    def backward(ctx, gout):
        rf, dirs, win = ctx.saved_tensors
        drf, dd = hs_surface_bwd(rf, dirs, win, gout.contiguous(), *ctx.sizes)
        need = ctx.needs_input_grad
        return (drf if need[0] else None, dd if need[1] else None, None, None)


class HSSupportReduce(torch.autograd.Function):
    """mean_s max_k relu(rf . dir_s) * (g @ W_s + b_s) on pre-gathered rows g,
    differentiable in g, rf, w, b and dirs.  ``store`` keeps the winner
    values for K13; without it K14 recomputes them.  ``feat`` and ``idx``
    (g = feat[idx]) are read by the forward's kernel and not differentiated."""

    @staticmethod
    def forward(ctx, g, rf, w, b, dirs, support_num: int, out_channel: int, store: bool = True,
                feat=None, idx=None):
        src = {"feat": feat, "idx": idx}
        if store:
            out, win, twin, pwin = hs_support_fwd(g, rf, w, b, dirs, support_num, out_channel,
                                                  **src)
            ctx.save_for_backward(g, rf, w, dirs, win, twin, pwin)
        else:
            out, win = hs_support_fwd(g, rf, w, b, dirs, support_num, out_channel, store=False,
                                      **src)
            ctx.save_for_backward(g, rf, w, b, dirs, win)
        ctx.sizes = (support_num, out_channel)
        ctx.store = store
        return out

    @staticmethod
    def backward(ctx, gout):
        bwd = hs_support_bwd if ctx.store else hs_support_bwd_recompute
        grads = bwd(*ctx.saved_tensors, gout.contiguous(), *ctx.sizes)
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) + (None,) * 5


def hs_surface_reduce(rf: torch.Tensor, dirs: torch.Tensor, support_num: int,
                      out_channel: int) -> torch.Tensor:
    """rf (B, N, K, 3), dirs (3, S*Co) -> (B, N, Co), differentiable."""
    return HSSurfaceReduce.apply(rf, dirs, support_num, out_channel)


def hs_support_reduce(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      dirs: torch.Tensor, support_num: int, out_channel: int,
                      store: bool = True, *, feat: torch.Tensor | None = None,
                      idx: torch.Tensor | None = None) -> torch.Tensor:
    """g (B, N, K, Cin), rf (B, N, K, 3), w (Cin, S*Co), b (S*Co,),
    dirs (3, S*Co) -> (B, N, Co), differentiable; ``store`` is the JAX
    package's ``bwd_store``.  On the card the forward also takes ``feat``
    and ``idx``, with g = feat[idx] (``hs_support_fwd``)."""
    return HSSupportReduce.apply(g, rf, w, b, dirs, support_num, out_channel, store, feat, idx)
