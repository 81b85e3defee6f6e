"""Differentiable HS reductions of the training path, through hand-written
CUDA kernels.

Counterpart of ``hspose_tpu/ops/pallas_hs.py``: ``hs_surface_reduce`` and
``hs_support_reduce(..., bwd_store=True)``, the v3 contract on pre-gathered
rows, with the TPU-only arguments (``tq``, ``exact``, ``kmajor``,
``theta_mxu``, ``bwd_exact``, ``interpret``) gone.  Layouts are (B, N, K, .).

Four kernels, each behind a wrapper that runs its plain version (in this
module) on CPU tensors and launches the kernel on CUDA tensors or raises:

* ``hs_surface_fwd`` (K12) and ``hs_surface_bwd`` (K15) ->
  ``csrc/hs_surface_train.cu``;
* ``hs_support_fwd`` (K11) and ``hs_support_bwd`` (K13) ->
  ``csrc/hs_support_train.cu``.

The forwards record, per (point, output column), the first k that reaches
the max (``win``) and, for the support reduction, theta and the projection
there (``twin``, ``pwin``); the backwards route each cotangent to that k
only.  ``torch.amax`` would split a gradient over ties instead.  The two
``autograd.Function``s, ``HSSurfaceReduce`` and ``HSSupportReduce``, pair
each forward with its backward.  Inputs are fp32, ``win`` int32.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def _first_max(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Max over dim 2 of (B, N, K, C) and the first k that reaches it."""
    win = torch.argmax(x, dim=2)  # the first maximal index
    return x.gather(2, win[:, :, None]).squeeze(2), win


def _onehot(win: torch.Tensor, K: int) -> torch.Tensor:
    """(B, N, C) winners -> (B, N, K, C) float one-hot over k."""
    ks = torch.arange(K, device=win.device)[:, None]
    return (ks == win[:, :, None, :].long()).to(torch.float32)


def hs_surface_fwd_plain(rf: torch.Tensor, dirs: torch.Tensor, support_num: int,
                         out_channel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean_s max_k relu(rf . dir_s), win): rf (B, N, K, 3), dirs (3, S*Co)
    -> (B, N, Co), int32 (B, N, S*Co)."""
    total, wins = 0.0, []
    for s in range(support_num):
        d = dirs[:, s * out_channel:(s + 1) * out_channel]
        m, w = _first_max(torch.relu(rf @ d))
        total = total + m
        wins.append(w)
    return total / support_num, torch.cat(wins, -1).to(torch.int32)


def hs_surface_bwd_plain(rf: torch.Tensor, dirs: torch.Tensor, win: torch.Tensor,
                         gb: torch.Tensor, support_num: int,
                         out_channel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangents (drf, dd) of ``hs_surface_fwd_plain`` for the output
    cotangent gb (B, N, Co), routed to the recorded winners where theta > 0."""
    co, K = out_channel, rf.shape[2]
    g = gb / support_num
    drf = torch.zeros_like(rf)
    dd = torch.zeros_like(dirs)
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        d = dirs[:, cols]
        theta = rf @ d  # (B, N, K, Co)
        du = torch.where(theta > 0, _onehot(win[..., cols], K) * g[:, :, None, :], 0.0)
        drf = drf + du @ d.t()
        dd[:, cols] = rf.reshape(-1, 3).t() @ du.reshape(-1, co)
    return drf, dd


def hs_support_fwd_plain(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, dirs: torch.Tensor, support_num: int,
                         out_channel: int):
    """(out, win, twin, pwin) of mean_s max_k relu(rf . dir_s) * (g @ W_s + b_s):
    g (B, N, K, Cin), rf (B, N, K, 3), w (Cin, S*Co), b (S*Co,), dirs (3, S*Co)
    -> (B, N, Co), int32 (B, N, S*Co), (B, N, S*Co), (B, N, S*Co)."""
    co = out_channel
    total, wins, twins, pwins = 0.0, [], [], []
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        theta = torch.relu(rf @ dirs[:, cols])
        proj = g @ w[:, cols] + b[cols]
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
    (hspose_tpu/ops/pallas_hs.py:385-401)."""
    co, (B, N, K, cin) = out_channel, g.shape
    gs = gb / support_num
    dg = torch.zeros_like(g)
    drf = torch.zeros_like(rf)
    dw = torch.zeros((cin, support_num * co), dtype=g.dtype, device=g.device)
    db = torch.zeros(support_num * co, dtype=g.dtype, device=g.device)
    dd = torch.zeros_like(dirs)
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        sel = _onehot(win[..., cols], K)
        tw, pw = twin[..., cols], pwin[..., cols]
        dpi = sel * (gs * tw)[:, :, None, :]
        du = sel * torch.where(tw > 0, gs * pw, 0.0)[:, :, None, :]
        dg = dg + dpi @ w[:, cols].t()
        drf = drf + du @ dirs[:, cols].t()
        dw[:, cols] = g.reshape(-1, cin).t() @ dpi.reshape(-1, co)
        db[cols] = dpi.sum((0, 1, 2))
        dd[:, cols] = rf.reshape(-1, 3).t() @ du.reshape(-1, co)
    return dg, drf, dw, db, dd


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

def _empty(shape, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def hs_surface_fwd(rf: torch.Tensor, dirs: torch.Tensor, support_num: int,
                   out_channel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K12: see ``hs_surface_fwd_plain``."""
    if _build.on_cpu(rf, dirs):
        return hs_surface_fwd_plain(rf, dirs, support_num, out_channel)
    S, co = support_num, out_channel
    _build.check(rf, "rf", torch.float32, (None, None, None, 3))
    B, N, K, _ = rf.shape
    _build.check(dirs, "dirs", torch.float32, (3, S * co))
    out, win = _empty((B, N, co), rf), _empty((B, N, S * co), rf, torch.int32)
    _build.launch("hs_surface_fwd", rf, dirs, out, win, B, N, K, S, co)
    hs_surface_fwd.launches += 1
    return out, win


def hs_surface_bwd(rf: torch.Tensor, dirs: torch.Tensor, win: torch.Tensor,
                   gb: torch.Tensor, support_num: int,
                   out_channel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K15: see ``hs_surface_bwd_plain``."""
    if _build.on_cpu(rf, dirs, win, gb):
        return hs_surface_bwd_plain(rf, dirs, win, gb, support_num, out_channel)
    S, co = support_num, out_channel
    _build.check(rf, "rf", torch.float32, (None, None, None, 3))
    B, N, K, _ = rf.shape
    _build.check(dirs, "dirs", torch.float32, (3, S * co))
    _build.check(win, "win", torch.int32, (B, N, S * co))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    parts = _build.load().hs_surface_bwd_parts(B, N)
    partial = _empty((parts, 3, S * co), rf)
    drf, dd = _empty(rf.shape, rf), _empty((3, S * co), rf)
    _build.launch("hs_surface_bwd", rf, dirs, win, gb, drf, partial, dd, B, N, K, S, co)
    hs_surface_bwd.launches += 1
    return drf, dd


def _check_support(g, rf, dirs, S, co):
    _build.check(g, "g", torch.float32, (None, None, None, None))
    B, N, K, cin = g.shape
    if g.data_ptr() % 16:
        raise ValueError("g: expected a 16-byte aligned tensor")
    if _build.load().hs_support_train_supported(K, cin, co):
        raise ValueError(f"hs_support kernels do not take K={K}, Cin={cin}, Co={co} "
                         f"(K <= 32, Cin and Co multiples of 4, Co/4 dividing 256)")
    _build.check(rf, "rf", torch.float32, (B, N, K, 3))
    _build.check(dirs, "dirs", torch.float32, (3, S * co))
    return B, N, K, cin


def hs_support_fwd(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   dirs: torch.Tensor, support_num: int, out_channel: int):
    """K11: see ``hs_support_fwd_plain``.  ``w`` may be a column slice of the
    layer's (Cin, (S+1)*Co) matrix."""
    if _build.on_cpu(g, rf, w, b, dirs):
        return hs_support_fwd_plain(g, rf, w, b, dirs, support_num, out_channel)
    S, co = support_num, out_channel
    B, N, K, cin = _check_support(g, rf, dirs, S, co)
    _build.check_rows(w, "w", (cin, S * co))
    _build.check(b, "b", torch.float32, (S * co,))
    out = _empty((B, N, co), g)
    win = _empty((B, N, S * co), g, torch.int32)
    twin, pwin = _empty((B, N, S * co), g), _empty((B, N, S * co), g)
    _build.launch("hs_support_fwd", g, rf, w, w.stride(0), b, dirs, out, win, twin, pwin,
                  B, N, K, cin, S, co)
    hs_support_fwd.launches += 1
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
    B, N, K, cin = _check_support(g, rf, dirs, S, co)
    _build.check_rows(w, "w", (cin, S * co))
    _build.check(win, "win", torch.int32, (B, N, S * co))
    _build.check(twin, "twin", torch.float32, (B, N, S * co))
    _build.check(pwin, "pwin", torch.float32, (B, N, S * co))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    parts = _build.load().hs_support_bwd_parts(B * N)
    wt = _empty((S * co, cin), g)  # scratch: W transposed
    partial = _empty((parts, cin + 4, S * co), g)
    red = _empty((cin + 4, S * co), g)
    dg, drf = _empty(g.shape, g), _empty(rf.shape, g)
    _build.launch("hs_support_bwd", g, rf, w, w.stride(0), dirs, win, twin, pwin, gb, dg,
                  drf, wt, partial, red, B, N, K, cin, S, co)
    hs_support_bwd.launches += 1
    return dg, drf, red[:cin], red[cin], red[cin + 1:]


hs_surface_fwd.launches = 0
hs_surface_bwd.launches = 0
hs_support_fwd.launches = 0
hs_support_bwd.launches = 0


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
    differentiable in g, rf, w, b and dirs."""

    @staticmethod
    def forward(ctx, g, rf, w, b, dirs, support_num: int, out_channel: int):
        out, win, twin, pwin = hs_support_fwd(g, rf, w, b, dirs, support_num, out_channel)
        ctx.save_for_backward(g, rf, w, dirs, win, twin, pwin)
        ctx.sizes = (support_num, out_channel)
        return out

    @staticmethod
    def backward(ctx, gout):
        grads = hs_support_bwd(*ctx.saved_tensors, gout.contiguous(), *ctx.sizes)
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) + (None, None)


def hs_surface_reduce(rf: torch.Tensor, dirs: torch.Tensor, support_num: int,
                      out_channel: int) -> torch.Tensor:
    """rf (B, N, K, 3), dirs (3, S*Co) -> (B, N, Co), differentiable."""
    return HSSurfaceReduce.apply(rf, dirs, support_num, out_channel)


def hs_support_reduce(g: torch.Tensor, rf: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      dirs: torch.Tensor, support_num: int, out_channel: int) -> torch.Tensor:
    """g (B, N, K, Cin), rf (B, N, K, 3), w (Cin, S*Co), b (S*Co,),
    dirs (3, S*Co) -> (B, N, Co), differentiable."""
    return HSSupportReduce.apply(g, rf, w, b, dirs, support_num, out_channel)
