"""HS graph-conv reductions through hand-written CUDA kernels.

Counterpart of ``hspose_tpu/ops/pallas_hs_fused.py`` (the forward of
``hs_surface_fused``, ``hs_support_fused`` and ``orl_global_fused``), with the
TPU-only arguments (``tq``, ``exact``, ``interpret``, ``slots``,
``vertices_q``) gone.  Each wrapper runs its plain version, in this module, on
CPU tensors, and on CUDA tensors launches its kernel or raises:

* ``hs_surface_fused`` -> ``csrc/hs_surface.cu``;
* ``hs_support_fused`` -> ``csrc/hs_support.cu`` (a tiled GEMM for the
  projection, then the gather-theta-max-mean reduction);
* ``orl_global_fused`` -> ``csrc/orl.cu``.

Inputs are fp32 and ``idx`` int32, with values in [0, N).  The bf16 tier
(the TPU kernels' ``exact=False``) takes bf16 ``feature_map`` / ``feature``
in the support and ORL reductions and ``exact=False`` in the surface one;
its kernels are the same sources instantiated for bf16 operands, with fp32
accumulation and fp32 outputs, and its plain versions reproduce the TPU
kernels' roundings (``_rf_fast``, ``_theta_fast``).  Each wrapper counts
fp32 launches in ``.launches`` and bf16 ones in ``.bf16_launches``.

Under ``torch.no_grad()``, or when no floating input requires grad, the
three ops launch the serving kernels above and nothing else.  A call that
needs a backward is fp32 only and goes through an autograd Function, as the
JAX ops' custom VJPs (pallas_hs_fused.py:893-977): a forward that also
records, per (point, column), the first k reaching the max (``win``), then a
backward that routes each cotangent to that k only.  Three more kernels
each, behind wrappers with plain versions here:

* ``hs_surface_fused_fwd`` (K2 with winners) and ``hs_surface_fused_bwd``
  (K9: dverts, dd) -> ``csrc/hs_surface.cu``;
* ``hs_support_fused_fwd`` (K3 with winners; the projection is kept as the
  backward's residual) and ``hs_support_fused_bwd`` (K8: dfeat, dverts, dW,
  db, dd) -> ``csrc/hs_support.cu``;
* ``orl_global_fused_fwd`` (K4 with winners) and ``orl_global_fused_bwd``
  (K10: dfeat) -> ``csrc/orl.cu``.

Their counters are ``.launches`` on each of the six.  The bf16 tier has no
backward yet (the ``exact=False`` branches of K8-K10): with grad on, a bf16
call whose input requires grad raises, on either device, rather than return
a result cut from the graph.  The training path on pre-gathered rows goes
through ``ops/cuda_hs.py``.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build
from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """The values ``x`` takes as bf16 operands, as fp32."""
    return x.to(torch.bfloat16).float()


def _rf_fast(vertices: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Unit receptive-field directions of the bf16 tier, (B, N, K, 3): xyz
    rounded to bf16 (pallas_hs_fused.py::_xyz_parts), rf = v[idx] - v,
    rf * (1 / max(sqrt((x^2 + y^2) + z^2), 1e-12)) in fp32, each operation
    correctly rounded in this order (``_rf_chain``), and the result rounded
    to bf16 for theta (``_theta_relu``).  The kernels stage the same values
    (csrc/hs_common.cuh::stage_rf)."""
    xyz = _bf16(vertices)
    rf = gather_neighbors(xyz, idx) - xyz[:, :, None, :]
    x, y, z = rf.unbind(-1)
    norm = torch.sqrt((x * x + y * y) + z * z)
    inv = torch.reciprocal(torch.clamp(norm, min=1e-12))
    return _bf16(rf * inv[..., None])


def _theta_fast(rfn: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """relu(rfn . d) of the bf16 tier, rfn (..., 3) and d (3, C) holding bf16
    values: every product is exact in fp32, added in the order x, y, z."""
    return torch.relu((rfn[..., 0:1] * d[0] + rfn[..., 1:2] * d[1]) + rfn[..., 2:3] * d[2])


def hs_surface_plain(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                     support_num: int, out_channel: int, exact: bool = True) -> torch.Tensor:
    """mean_s max_k relu(normalize(v[idx] - v) . dir_s): (B, N, 3), (B, N, K),
    (3, S*Co) -> (B, N, Co).  ``exact=False``: the bf16 tier's roundings."""
    if exact:
        rf = neighbor_directions_normalized(vertices, idx)  # (B, N, K, 3)
    else:
        rf, dirs = _rf_fast(vertices, idx), _bf16(dirs)
    total = 0.0
    for s in range(support_num):
        d = dirs[:, s * out_channel:(s + 1) * out_channel]
        theta = torch.relu(rf @ d) if exact else _theta_fast(rf, d)
        total = total + theta.amax(dim=2)
    return total / support_num


def hs_support_plain(feature_map: torch.Tensor, vertices: torch.Tensor,
                     idx: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                     dirs: torch.Tensor, support_num: int,
                     out_channel: int) -> torch.Tensor:
    """mean_s max_k relu(rf . dir_s) * (feat @ W_s + b_s)[idx], projecting
    before the gather as the reference does: (B, N, Cin), (B, N, 3),
    (B, N, K), (Cin, S*Co), (S*Co,), (3, S*Co) -> (B, N, Co).

    bf16 ``feature_map`` is the bf16 tier: the projection multiplies the bf16
    features by the weights rounded to bf16, exactly, and sums in fp32
    (``_mm``); rf and directions take the tier's roundings."""
    exact = feature_map.dtype != torch.bfloat16
    if exact:
        rf = neighbor_directions_normalized(vertices, idx)
        proj = feature_map @ weights + bias  # (B, N, S*Co)
    else:
        rf, dirs = _rf_fast(vertices, idx), _bf16(dirs)
        proj = feature_map.float() @ _bf16(weights) + bias
    total = 0.0
    for s in range(support_num):
        cols = slice(s * out_channel, (s + 1) * out_channel)
        theta = torch.relu(rf @ dirs[:, cols]) if exact else _theta_fast(rf, dirs[:, cols])
        total = total + (theta * gather_neighbors(proj[..., cols], idx)).amax(dim=2)
    return total / support_num


def orl_global_plain(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mean_n max_k feat[idx]: (B, N, C), (B, N, K) -> (B, 1, C) fp32 (for
    bf16 features the maxima are bf16 values, the mean fp32)."""
    return gather_neighbors(feature, idx).amax(dim=2).float().mean(dim=1, keepdim=True)


def _first_max(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Max over dim 2 of (B, N, K, C) and the first k that reaches it."""
    win = torch.argmax(x, dim=2)  # the first maximal index
    return x.gather(2, win[:, :, None]).squeeze(2), win


def _onehot(win: torch.Tensor, K: int) -> torch.Tensor:
    """(B, N, C) winners -> (B, N, K, C) float one-hot over k."""
    ks = torch.arange(K, device=win.device)[:, None]
    return (ks == win[:, :, None, :].long()).to(torch.float32)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(name: str) -> None:
    raise RuntimeError(f"{name}: the bf16 tier has no backward yet (the exact=False branches "
                       f"of K8-K10 are queued): call it under torch.no_grad(), or train "
                       f"through ops/cuda_hs.py")


def _check_idx(idx: torch.Tensor, B: int, N: int) -> int:
    _build.check(idx, "idx", torch.int32, (B, N, None))
    return idx.shape[2]


def _count(wrapper, fast: bool) -> None:
    if fast:
        wrapper.bf16_launches += 1
    else:
        wrapper.launches += 1


def hs_surface_fused(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                     support_num: int, out_channel: int, exact: bool = True) -> torch.Tensor:
    """HS surface reduction (conv_0); see ``hs_surface_plain``.  ``exact=False``
    is the bf16 tier; inputs stay fp32 either way.  Differentiable in
    vertices and dirs (fp32)."""
    if _needs_grad(vertices, dirs):
        if not exact:
            _refuse_grad("hs_surface_fused")
        return HSSurfaceFused.apply(vertices, idx, dirs, support_num, out_channel)
    if _build.on_cpu(vertices, idx, dirs):
        return hs_surface_plain(vertices, idx, dirs, support_num, out_channel, exact)
    S, co = support_num, out_channel
    _build.check(vertices, "vertices", torch.float32, (None, None, 3))
    B, N, _ = vertices.shape
    K = _check_idx(idx, B, N)
    _build.check(dirs, "dirs", torch.float32, (3, S * co))
    out = torch.empty((B, N, co), dtype=torch.float32, device=vertices.device)
    _build.launch("hs_surface", vertices, idx, dirs, out, B, N, K, S, co, int(not exact))
    _count(hs_surface_fused, not exact)
    return out


def hs_support_fused(feature_map: torch.Tensor, vertices: torch.Tensor,
                     idx: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                     dirs: torch.Tensor, support_num: int,
                     out_channel: int) -> torch.Tensor:
    """HS support reduction (conv_1 .. conv_4); see ``hs_support_plain``.
    bf16 ``feature_map`` runs the bf16 tier; the other inputs stay fp32.

    ``weights`` may be a column slice of a wider matrix (rows need not be
    adjacent, but each row must be).  Differentiable in every float input
    (fp32)."""
    tensors = (feature_map, vertices, idx, weights, bias, dirs)
    if _needs_grad(feature_map, vertices, weights, bias, dirs):
        if feature_map.dtype == torch.bfloat16:
            _refuse_grad("hs_support_fused")
        return HSSupportFused.apply(*tensors, support_num, out_channel)
    if _build.on_cpu(*tensors):
        return hs_support_plain(*tensors, support_num, out_channel)
    S, co = support_num, out_channel
    fast = feature_map.dtype == torch.bfloat16
    _build.check(feature_map, "feature_map", torch.bfloat16 if fast else torch.float32,
                 (None, None, None))
    B, N, cin = feature_map.shape
    _build.check(vertices, "vertices", torch.float32, (B, N, 3))
    K = _check_idx(idx, B, N)
    _build.check_rows(weights, "weights", (cin, S * co))
    _build.check(bias, "bias", torch.float32, (S * co,))
    _build.check(dirs, "dirs", torch.float32, (3, S * co))
    proj = torch.empty((B, N, S * co), dtype=torch.float32, device=feature_map.device)
    out = torch.empty((B, N, co), dtype=torch.float32, device=feature_map.device)
    _build.launch("hs_support_project", feature_map, int(fast), weights, weights.stride(0),
                  bias, proj, B * N, cin, S * co)
    _build.launch("hs_support_reduce", proj, vertices, idx, dirs, out, B, N, K, S, co,
                  int(fast))
    _count(hs_support_fused, fast)
    return out


def orl_global_fused(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ORL global branch; see ``orl_global_plain``.  bf16 ``feature`` runs
    the bf16 tier; the output is fp32 either way.  Differentiable in
    ``feature`` (fp32)."""
    if _needs_grad(feature):
        if feature.dtype == torch.bfloat16:
            _refuse_grad("orl_global_fused")
        return ORLGlobalFused.apply(feature, idx)
    if _build.on_cpu(feature, idx):
        return orl_global_plain(feature, idx)
    fast = feature.dtype == torch.bfloat16
    _build.check(feature, "feature", torch.bfloat16 if fast else torch.float32,
                 (None, None, None))
    B, N, C = feature.shape
    K = _check_idx(idx, B, N)
    tiles = _build.load().hs_orl_tiles(N)
    partial = torch.empty((B, tiles, C), dtype=torch.float32, device=feature.device)
    out = torch.empty((B, 1, C), dtype=torch.float32, device=feature.device)
    _build.launch("hs_orl", feature, int(fast), idx, partial, out, B, N, K, C)
    _count(orl_global_fused, fast)
    return out


for _wrapper in (hs_surface_fused, hs_support_fused, orl_global_fused):
    _wrapper.launches = 0
    _wrapper.bf16_launches = 0


# --------------------------------------------------------------------------- #
# the differentiable fp32 ops: plain versions
# --------------------------------------------------------------------------- #

def _rf_chain(vertices: torch.Tensor, idx: torch.Tensor):
    """rf = v[idx] - v (B, N, K, 3), its norm (B, N, K, 1) and the unit
    direction rf / max(norm, 1e-12), as the forward forms it."""
    rf = gather_neighbors(vertices, idx) - vertices[:, :, None, :]
    norm = torch.linalg.vector_norm(rf, dim=-1, keepdim=True)
    return rf, norm, rf / torch.clamp(norm, min=1e-12)


def _rf_grad(rf: torch.Tensor, norm: torch.Tensor, drfn: torch.Tensor) -> torch.Tensor:
    """The cotangent of rf from that of rfn = rf / max(norm, 1e-12)
    (pallas_hs_fused.py::_rf_chain_bwd): the norm's term is masked where
    norm < 1e-12, so a duplicated point (rf = 0) passes nothing."""
    inv = 1.0 / torch.clamp(norm, min=1e-12)
    s = (drfn * rf).sum(-1, keepdim=True)
    return drfn * inv - rf * torch.where(norm >= 1e-12, s * inv * inv * inv, 0.0)


def _scatter_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, K, C) per (query, neighbour) -> (B, N, C): each row's sum at the
    source row idx[b, q, k] names."""
    B, N, K, C = x.shape
    src = idx.long().reshape(B, N * K, 1).expand(B, N * K, C)
    return torch.zeros((B, N, C), dtype=x.dtype, device=x.device).scatter_add_(
        1, src, x.reshape(B, N * K, C))


def _dverts(drf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """dverts: the source rows' scatter of drf plus the query-centre term
    -sum_k drf (pallas_hs_fused.py:487-490, :734)."""
    return _scatter_rows(drf, idx) - drf.sum(2)


def hs_surface_fused_fwd_plain(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                               support_num: int, out_channel: int):
    """(``hs_surface_plain``'s output, win): win (B, N, S*Co) int32 holds the
    first k reaching each column's max of relu(theta)."""
    rf = neighbor_directions_normalized(vertices, idx)
    total, wins = 0.0, []
    for s in range(support_num):
        m, w = _first_max(torch.relu(rf @ dirs[:, s * out_channel:(s + 1) * out_channel]))
        total = total + m
        wins.append(w)
    return total / support_num, torch.cat(wins, -1).to(torch.int32)


def hs_surface_fused_bwd_plain(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                               win: torch.Tensor, gb: torch.Tensor, support_num: int,
                               out_channel: int):
    """Cotangents (dverts, dd) of ``hs_surface_fused_fwd_plain`` for the
    output cotangent gb (B, N, Co): gb / S routed to each column's winner
    where theta > 0 (pallas_hs_fused.py:524-541)."""
    co, K = out_channel, idx.shape[2]
    rf, norm, rfn = _rf_chain(vertices, idx)
    gs = gb / support_num
    drfn = torch.zeros_like(rf)
    dd = torch.zeros_like(dirs)
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        d = dirs[:, cols]
        theta = torch.relu(rfn @ d)
        dz = torch.where(theta > 0, _onehot(win[..., cols], K) * gs[:, :, None, :], 0.0)
        drfn = drfn + dz @ d.t()
        dd[:, cols] = rfn.reshape(-1, 3).t() @ dz.reshape(-1, co)
    return _dverts(_rf_grad(rf, norm, drfn), idx), dd


def hs_support_fused_fwd_plain(feature_map: torch.Tensor, vertices: torch.Tensor,
                               idx: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                               dirs: torch.Tensor, support_num: int, out_channel: int):
    """(``hs_support_plain``'s output, win, proj): win (B, N, S*Co) int32 holds
    the first k reaching each column's max of theta * P, proj = feat @ W + b
    (B, N, S*Co) is the backward's residual."""
    rf = neighbor_directions_normalized(vertices, idx)
    proj = feature_map @ weights + bias
    total, wins = 0.0, []
    for s in range(support_num):
        cols = slice(s * out_channel, (s + 1) * out_channel)
        theta = torch.relu(rf @ dirs[:, cols])
        m, w = _first_max(theta * gather_neighbors(proj[..., cols], idx))
        total = total + m
        wins.append(w)
    return total / support_num, torch.cat(wins, -1).to(torch.int32), proj


def hs_support_fused_bwd_plain(feature_map: torch.Tensor, vertices: torch.Tensor,
                               idx: torch.Tensor, weights: torch.Tensor, dirs: torch.Tensor,
                               win: torch.Tensor, proj: torch.Tensor, gb: torch.Tensor,
                               support_num: int, out_channel: int):
    """Cotangents (dfeat, dverts, dW, db, dd) of ``hs_support_fused_fwd_plain``
    for the output cotangent gb (B, N, Co) (pallas_hs_fused.py:463-490): at
    each column's winner, dproj = gb/S * theta goes to the projection of the
    source row and dz = gb/S * P (where theta > 0) to rf and the directions;
    dfeat = dproj_src W^T, dW = feat^T dproj_src and db = sum dproj_src
    from dproj scattered to its source rows."""
    co, (B, N, K), cin = out_channel, idx.shape, feature_map.shape[2]
    rf, norm, rfn = _rf_chain(vertices, idx)
    gs = gb / support_num
    drfn = torch.zeros_like(rf)
    dd = torch.zeros_like(dirs)
    dproj_src = torch.zeros_like(proj)
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        d = dirs[:, cols]
        theta = torch.relu(rfn @ d)
        dprod = _onehot(win[..., cols], K) * gs[:, :, None, :]
        dz = torch.where(theta > 0, dprod * gather_neighbors(proj[..., cols], idx), 0.0)
        drfn = drfn + dz @ d.t()
        dd[:, cols] = rfn.reshape(-1, 3).t() @ dz.reshape(-1, co)
        dproj_src[..., cols] = _scatter_rows(dprod * theta, idx)
    dfeat = dproj_src @ weights.t()
    dw = feature_map.reshape(-1, cin).t() @ dproj_src.reshape(B * N, -1)
    return dfeat, _dverts(_rf_grad(rf, norm, drfn), idx), dw, dproj_src.sum((0, 1)), dd


def orl_global_fused_fwd_plain(feature: torch.Tensor, idx: torch.Tensor):
    """(``orl_global_plain``'s output, win): win (B, N, C) int32 holds the
    first k reaching each channel's max."""
    m, win = _first_max(gather_neighbors(feature, idx))
    return m.mean(dim=1, keepdim=True), win.to(torch.int32)


def orl_global_fused_bwd_plain(idx: torch.Tensor, win: torch.Tensor,
                               gb: torch.Tensor) -> torch.Tensor:
    """dfeat (B, N, C) of ``orl_global_fused_fwd_plain`` for the output
    cotangent gb (B, 1, C): gb / N at each (point, channel)'s winning
    neighbour, counted per source row (pallas_hs_fused.py:557-570)."""
    B, N, K = idx.shape
    C = win.shape[-1]
    counts = _scatter_rows(torch.stack([(win == k).float() for k in range(K)], 2), idx)
    return counts * (gb.reshape(B, 1, C) / N)


# --------------------------------------------------------------------------- #
# the differentiable fp32 ops: kernel wrappers and autograd
# --------------------------------------------------------------------------- #

def _empty(shape, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _check_fused(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor, S: int,
                 co: int) -> tuple[int, int, int]:
    _build.check(vertices, "vertices", torch.float32, (None, None, 3))
    B, N, _ = vertices.shape
    K = _check_idx(idx, B, N)
    if K > 32:
        raise ValueError(f"the fused backwards take K <= 32, got K={K}")
    _build.check(dirs, "dirs", torch.float32, (3, S * co))
    return B, N, K


def _inverse_lists(idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch of the inverse neighbour lists: rowptr (B, N + 1), ent (B, N*K)."""
    B, N, K = idx.shape
    return _empty((B, N + 1), idx, torch.int32), _empty((B, N * K), idx, torch.int32)


def hs_surface_fused_fwd(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                         support_num: int, out_channel: int):
    """K2 with winners: see ``hs_surface_fused_fwd_plain``."""
    if _build.on_cpu(vertices, idx, dirs):
        return hs_surface_fused_fwd_plain(vertices, idx, dirs, support_num, out_channel)
    S, co = support_num, out_channel
    B, N, K = _check_fused(vertices, idx, dirs, S, co)
    out, win = _empty((B, N, co), vertices), _empty((B, N, S * co), vertices, torch.int32)
    _build.launch("hs_surface_win", vertices, idx, dirs, out, win, B, N, K, S, co)
    hs_surface_fused_fwd.launches += 1
    return out, win


def hs_surface_fused_bwd(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                         win: torch.Tensor, gb: torch.Tensor, support_num: int,
                         out_channel: int):
    """K9: see ``hs_surface_fused_bwd_plain``."""
    if _build.on_cpu(vertices, idx, dirs, win, gb):
        return hs_surface_fused_bwd_plain(vertices, idx, dirs, win, gb, support_num, out_channel)
    S, co = support_num, out_channel
    B, N, K = _check_fused(vertices, idx, dirs, S, co)
    _build.check(win, "win", torch.int32, (B, N, S * co))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    rowptr, ent = _inverse_lists(idx)
    parts = _build.load().hs_fused_bwd_parts(B, N)
    dverts, red = _empty((B, N, 3), vertices), _empty((3, S * co), vertices)
    _build.launch("hs_surface_fused_bwd", vertices, idx, dirs, win, gb, rowptr, ent,
                  _empty((B, N, S * co), vertices), _empty((B, N, K, 3), vertices),
                  _empty((B, N, 3), vertices), _empty((parts, 3, S * co), vertices), dverts, red,
                  B, N, K, S, co)
    hs_surface_fused_bwd.launches += 1
    return dverts, red


def hs_support_fused_fwd(feature_map: torch.Tensor, vertices: torch.Tensor, idx: torch.Tensor,
                         weights: torch.Tensor, bias: torch.Tensor, dirs: torch.Tensor,
                         support_num: int, out_channel: int):
    """K3 with winners: see ``hs_support_fused_fwd_plain``."""
    tensors = (feature_map, vertices, idx, weights, bias, dirs)
    if _build.on_cpu(*tensors):
        return hs_support_fused_fwd_plain(*tensors, support_num, out_channel)
    S, co = support_num, out_channel
    B, N, K = _check_fused(vertices, idx, dirs, S, co)
    _build.check(feature_map, "feature_map", torch.float32, (B, N, None))
    cin = feature_map.shape[2]
    _build.check_rows(weights, "weights", (cin, S * co))
    _build.check(bias, "bias", torch.float32, (S * co,))
    proj, out = _empty((B, N, S * co), vertices), _empty((B, N, co), vertices)
    win = _empty((B, N, S * co), vertices, torch.int32)
    _build.launch("hs_support_project", feature_map, 0, weights, weights.stride(0), bias, proj,
                  B * N, cin, S * co)
    _build.launch("hs_support_reduce_win", proj, vertices, idx, dirs, out, win, B, N, K, S, co)
    hs_support_fused_fwd.launches += 1
    return out, win, proj


def hs_support_fused_bwd(feature_map: torch.Tensor, vertices: torch.Tensor, idx: torch.Tensor,
                         weights: torch.Tensor, dirs: torch.Tensor, win: torch.Tensor,
                         proj: torch.Tensor, gb: torch.Tensor, support_num: int,
                         out_channel: int):
    """K8: see ``hs_support_fused_bwd_plain``."""
    tensors = (feature_map, vertices, idx, weights, dirs, win, proj, gb)
    if _build.on_cpu(*tensors):
        return hs_support_fused_bwd_plain(*tensors, support_num, out_channel)
    S, co = support_num, out_channel
    B, N, K = _check_fused(vertices, idx, dirs, S, co)
    _build.check(feature_map, "feature_map", torch.float32, (B, N, None))
    cin, sc = feature_map.shape[2], S * co
    _build.check_rows(weights, "weights", (cin, sc))
    _build.check(win, "win", torch.int32, (B, N, sc))
    _build.check(proj, "proj", torch.float32, (B, N, sc))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    lib = _build.load()
    rowptr, ent = _inverse_lists(idx)
    dfeat, dverts = _empty((B, N, cin), vertices), _empty((B, N, 3), vertices)
    dw, red = _empty((cin, sc), vertices), _empty((4, sc), vertices)
    _build.launch("hs_support_fused_bwd", feature_map, weights, weights.stride(0), vertices, idx,
                  dirs, win, proj, gb, rowptr, ent, *(_empty((B, N, sc), vertices) for _ in "zps"),
                  _empty((B, N, K, 3), vertices), _empty((B, N, 3), vertices),
                  _empty((lib.hs_fused_bwd_parts(B, N), 4, sc), vertices),
                  _empty((lib.hs_support_fused_dw_parts(B * N), cin, sc), vertices),
                  dfeat, dverts, dw, red, B, N, K, cin, S, co)
    hs_support_fused_bwd.launches += 1
    return dfeat, dverts, dw, red[3], red[:3]


def orl_global_fused_fwd(feature: torch.Tensor, idx: torch.Tensor):
    """K4 with winners: see ``orl_global_fused_fwd_plain``."""
    if _build.on_cpu(feature, idx):
        return orl_global_fused_fwd_plain(feature, idx)
    _build.check(feature, "feature", torch.float32, (None, None, None))
    B, N, C = feature.shape
    K = _check_idx(idx, B, N)
    if K > 32:
        raise ValueError(f"the fused backwards take K <= 32, got K={K}")
    partial = _empty((B, _build.load().hs_orl_tiles(N), C), feature)
    out, win = _empty((B, 1, C), feature), _empty((B, N, C), feature, torch.int32)
    _build.launch("hs_orl_win", feature, idx, partial, out, win, B, N, K, C)
    orl_global_fused_fwd.launches += 1
    return out, win


def orl_global_fused_bwd(idx: torch.Tensor, win: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """K10: see ``orl_global_fused_bwd_plain``."""
    if _build.on_cpu(idx, win, gb):
        return orl_global_fused_bwd_plain(idx, win, gb)
    B, N, K = idx.shape
    _build.check(idx, "idx", torch.int32, (B, N, K))
    _build.check(win, "win", torch.int32, (B, N, None))
    C = win.shape[2]
    _build.check(gb, "gb", torch.float32, (B, 1, C))
    rowptr, ent = _inverse_lists(idx)
    dfeat = _empty((B, N, C), win)
    _build.launch("hs_orl_bwd", idx, win, gb, rowptr, ent, dfeat, B, N, K, C)
    orl_global_fused_bwd.launches += 1
    return dfeat


for _wrapper in (hs_surface_fused_fwd, hs_surface_fused_bwd, hs_support_fused_fwd,
                 hs_support_fused_bwd, orl_global_fused_fwd, orl_global_fused_bwd):
    _wrapper.launches = 0


class HSSurfaceFused(torch.autograd.Function):
    """``hs_surface_fused`` differentiable in vertices and dirs (fp32)."""

    @staticmethod
    def forward(ctx, vertices, idx, dirs, support_num: int, out_channel: int):
        out, win = hs_surface_fused_fwd(vertices, idx, dirs, support_num, out_channel)
        ctx.save_for_backward(vertices, idx, dirs, win)
        ctx.sizes = (support_num, out_channel)
        return out

    @staticmethod
    def backward(ctx, gout):
        vertices, idx, dirs, win = ctx.saved_tensors
        dverts, dd = hs_surface_fused_bwd(vertices, idx, dirs, win, gout.contiguous(),
                                          *ctx.sizes)
        need = ctx.needs_input_grad
        return dverts if need[0] else None, None, dd if need[2] else None, None, None


class HSSupportFused(torch.autograd.Function):
    """``hs_support_fused`` differentiable in feature_map, vertices, weights,
    bias and dirs (fp32)."""

    @staticmethod
    def forward(ctx, feature_map, vertices, idx, weights, bias, dirs, support_num: int,
                out_channel: int):
        out, win, proj = hs_support_fused_fwd(feature_map, vertices, idx, weights, bias, dirs,
                                              support_num, out_channel)
        ctx.save_for_backward(feature_map, vertices, idx, weights, dirs, win, proj)
        ctx.sizes = (support_num, out_channel)
        return out

    @staticmethod
    def backward(ctx, gout):
        dfeat, dverts, dw, db, dd = hs_support_fused_bwd(*ctx.saved_tensors, gout.contiguous(),
                                                         *ctx.sizes)
        grads = (dfeat, dverts, None, dw, db, dd, None, None)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


class ORLGlobalFused(torch.autograd.Function):
    """``orl_global_fused`` differentiable in feature (fp32)."""

    @staticmethod
    def forward(ctx, feature, idx):
        out, win = orl_global_fused_fwd(feature, idx)
        ctx.save_for_backward(idx, win)
        return out

    @staticmethod
    def backward(ctx, gout):
        idx, win = ctx.saved_tensors
        dfeat = orl_global_fused_bwd(idx, win, gout.contiguous())
        return dfeat if ctx.needs_input_grad[0] else None, None
