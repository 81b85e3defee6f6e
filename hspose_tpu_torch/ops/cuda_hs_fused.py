"""HS graph-conv reductions through hand-written CUDA kernels.

Counterpart of ``hspose_tpu/ops/pallas_hs_fused.py`` (the forward of
``hs_surface_fused``, ``hs_support_fused`` and ``orl_global_fused``), with the
TPU-only arguments (``tq``, ``exact``, ``interpret``, ``slots``,
``vertices_q``) gone.  Each wrapper runs its plain version, in this module, on
CPU tensors, and on CUDA tensors launches its kernel or raises:

* ``hs_surface_fused`` -> ``csrc/hs_surface.cu``;
* ``hs_support_fused`` -> ``csrc/hs_support.cu`` (a tiled GEMM for the
  projection, on the tensor cores in the bf16 tier, then the
  gather-theta-max-mean reduction);
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
needs a backward goes through an autograd Function, as the JAX ops' custom
VJPs (pallas_hs_fused.py:893-977): a forward that also records, per (point,
column), the first k reaching the max (``win``), then a backward that
routes each cotangent to that k only.  Three more kernels each, behind
wrappers with plain versions here:

* ``hs_surface_fused_fwd`` (K2 with winners) and ``hs_surface_fused_bwd``
  (K9: dverts, dd) -> ``csrc/hs_surface.cu``;
* ``hs_support_fused_fwd`` (K3 with winners; the projection is kept as the
  backward's residual) and ``hs_support_fused_bwd`` (K8: dfeat, dverts, dW,
  db, dd) -> ``csrc/hs_support.cu``;
* ``orl_global_fused_fwd`` (K4 with winners) and ``orl_global_fused_bwd``
  (K10: dfeat) -> ``csrc/orl.cu``.

Both tiers take this route.  In the bf16 tier (``exact=False`` of the same
TPU kernels) the backwards round where the TPU kernels' one-pass products
round (pallas_hs_fused.py:123-197): dz and each (query, k) row of dproj,
dg and drf are rounded to bf16 as product operands or before the
source-row sum, the query-centre term of dverts and db stay fp32, gb / S
and gb / N are gb times the fp32 reciprocal, and dfeat comes back in bf16
(the VJP's cast to the feature dtype); dverts, dW, db and dd are fp32.
Their counters are ``.launches`` (fp32) and ``.bf16_launches`` on each of
the six.  The training path on pre-gathered rows goes through
``ops/cuda_hs.py``.
"""

from __future__ import annotations

import torch

from hspose_tpu_torch.ops import _build
from hspose_tpu_torch.ops.knn import gather_neighbors, neighbor_directions_normalized


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """The values ``x`` takes as bf16 operands, as fp32."""
    return x.to(torch.bfloat16).float()


def _rf_chain_fast(vertices: torch.Tensor, idx: torch.Tensor):
    """rf = v[idx] - v (B, N, K, 3) on xyz rounded to bf16
    (pallas_hs_fused.py::_xyz_parts), its norm sqrt((x^2 + y^2) + z^2)
    (B, N, K, 1) and rf * (1 / max(norm, 1e-12)), in fp32, each operation
    correctly rounded in this order (``_rf_chain``)."""
    xyz = _bf16(vertices)
    rf = gather_neighbors(xyz, idx) - xyz[:, :, None, :]
    x, y, z = rf.unbind(-1)
    norm = torch.sqrt((x * x + y * y) + z * z)[..., None]
    return rf, norm, rf * torch.reciprocal(torch.clamp(norm, min=1e-12))


def _rf_fast(vertices: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Unit receptive-field directions of the bf16 tier, (B, N, K, 3):
    ``_rf_chain_fast``'s, rounded to bf16 for theta (``_theta_relu``).  The
    kernels stage the same values (csrc/hs_common.cuh::stage_rf)."""
    return _bf16(_rf_chain_fast(vertices, idx)[2])


def _theta_fast(rfn: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """relu(rfn . d) of the bf16 tier, rfn (..., 3) and d (3, C) holding bf16
    values: every product is exact in fp32, added in the order x, y, z."""
    return torch.relu((rfn[..., 0:1] * d[0] + rfn[..., 1:2] * d[1]) + rfn[..., 2:3] * d[2])


def _per_support(gb: torch.Tensor, support_num: int, fast: bool) -> torch.Tensor:
    """gb / S.  The bf16 tier takes gb times 1/S rounded to fp32, as XLA
    forms a division by a constant in the TPU kernels: the one-ulp
    difference from a true division can move the rounding to bf16 that
    follows (csrc/hs_common.cuh::div_s)."""
    if fast:
        return gb * (torch.tensor(1.0) / support_num).item()
    return gb / support_num


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
    vertices and dirs."""
    if _needs_grad(vertices, dirs):
        return HSSurfaceFused.apply(vertices, idx, dirs, support_num, out_channel, exact)
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


def _support_project(feature_map: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                     S: int, co: int, fast: bool) -> torch.Tensor:
    """P = feat @ W + b, (B, N, S*co) fp32, by ``hs_support_project``.  The
    kernels read float4 columns and 16-byte rows."""
    B, N, cin = feature_map.shape
    if (co % 4 or weights.stride(0) % 4 or cin % (8 if fast else 4)
            or weights.data_ptr() % 16 or bias.data_ptr() % 16):
        raise ValueError(f"the support kernels take out_channel and the weights' row stride "
                         f"in multiples of 4, Cin in multiples of {8 if fast else 4} and "
                         f"16-byte aligned weights and bias; got out_channel={co}, Cin={cin}, "
                         f"stride {weights.stride(0)}")
    proj = torch.empty((B, N, S * co), dtype=torch.float32, device=feature_map.device)
    _build.launch("hs_support_project", feature_map, int(fast), weights, weights.stride(0),
                  bias, proj, B * N, cin, S * co)
    return proj


def hs_support_fused(feature_map: torch.Tensor, vertices: torch.Tensor,
                     idx: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                     dirs: torch.Tensor, support_num: int,
                     out_channel: int) -> torch.Tensor:
    """HS support reduction (conv_1 .. conv_4); see ``hs_support_plain``.
    bf16 ``feature_map`` runs the bf16 tier; the other inputs stay fp32.

    ``weights`` may be a column slice of a wider matrix (rows need not be
    adjacent, but each row must be).  Differentiable in every float input."""
    tensors = (feature_map, vertices, idx, weights, bias, dirs)
    if _needs_grad(feature_map, vertices, weights, bias, dirs):
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
    proj = _support_project(feature_map, weights, bias, S, co, fast)
    out = torch.empty((B, N, co), dtype=torch.float32, device=feature_map.device)
    _build.launch("hs_support_reduce", proj, vertices, idx, dirs, out, B, N, K, S, co,
                  int(fast))
    _count(hs_support_fused, fast)
    return out


# What the ORL kernel (csrc/orl.cu) takes on the card; it picks its own
# slice of channels and returns an error for anything else.
ORL_LIMITS = ("the ORL kernel takes C a multiple of 16 bytes, 16-byte aligned features and "
              "N rows of a 16-byte slice of channels with their tile sums in 227 KB of shared "
              "memory (N <= 14087 in fp32, 13672 in bf16)")


def _launch_orl(name: str, feature: torch.Tensor, *args) -> None:
    try:
        _build.launch(name, feature, *args)
    except RuntimeError as err:
        raise RuntimeError(f"{err}; {ORL_LIMITS}: got (B, N, C) = {tuple(feature.shape)}, "
                           f"{feature.dtype}") from err


def orl_global_fused(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ORL global branch; see ``orl_global_plain``.  bf16 ``feature`` runs
    the bf16 tier; the output is fp32 either way.  Differentiable in
    ``feature``."""
    if _needs_grad(feature):
        return ORLGlobalFused.apply(feature, idx)
    if _build.on_cpu(feature, idx):
        return orl_global_plain(feature, idx)
    fast = feature.dtype == torch.bfloat16
    _build.check(feature, "feature", torch.bfloat16 if fast else torch.float32,
                 (None, None, None))
    B, N, C = feature.shape
    K = _check_idx(idx, B, N)
    out = torch.empty((B, 1, C), dtype=torch.float32, device=feature.device)
    _launch_orl("hs_orl", feature, int(fast), idx, out, B, N, K, C)
    _count(orl_global_fused, fast)
    return out


for _wrapper in (hs_surface_fused, hs_support_fused, orl_global_fused):
    _wrapper.launches = 0
    _wrapper.bf16_launches = 0


# --------------------------------------------------------------------------- #
# the differentiable ops: plain versions
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


def _dverts(drf: torch.Tensor, idx: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """dverts: the source rows' scatter of drf plus the query-centre term
    -sum_k drf (pallas_hs_fused.py:487-490, :734).  The bf16 tier scatters
    each row of drf rounded to bf16 (``_scatter_rows``' one-pass product)
    and sums the centre term unrounded."""
    return _scatter_rows(_bf16(drf) if fast else drf, idx) - drf.sum(2)


def hs_surface_fused_fwd_plain(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                               support_num: int, out_channel: int, exact: bool = True):
    """(``hs_surface_plain``'s output, win): win (B, N, S*Co) int32 holds the
    first k reaching each column's max of relu(theta).  ``exact=False``:
    the bf16 tier's roundings."""
    if exact:
        rf = neighbor_directions_normalized(vertices, idx)
    else:
        rf, dirs = _rf_fast(vertices, idx), _bf16(dirs)
    total, wins = 0.0, []
    for s in range(support_num):
        d = dirs[:, s * out_channel:(s + 1) * out_channel]
        m, w = _first_max(torch.relu(rf @ d) if exact else _theta_fast(rf, d))
        total = total + m
        wins.append(w)
    return total / support_num, torch.cat(wins, -1).to(torch.int32)


def _rf_grad_fast(rf: torch.Tensor, norm: torch.Tensor, drfn: torch.Tensor) -> torch.Tensor:
    """``_rf_grad`` of the bf16 tier, each fp32 operation in a fixed order
    that the kernel repeats (csrc/hs_fused_bwd.cuh::rf_grad_kernel): each
    row of drf is rounded to bf16 before its source-row sum, so both sides
    must hold the same fp32 row."""
    inv = torch.reciprocal(torch.clamp(norm, min=1e-12))
    x, y, z = rf.unbind(-1)
    a, b, c = drfn.unbind(-1)
    s = (a * x + b * y) + c * z
    h = torch.where(norm[..., 0] >= 1e-12, s * inv[..., 0] * inv[..., 0] * inv[..., 0], 0.0)
    return drfn * inv - rf * h[..., None]


def _fused_bwd_fast(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                    win: torch.Tensor, gb: torch.Tensor, support_num: int, out_channel: int,
                    proj: torch.Tensor | None = None):
    """The bf16 tier's (``exact=False``) backward of the surface reduction,
    or of the support reduction given its projection ``proj``
    (pallas_hs_fused.py:463-490, :524-541): theta at the winner as the
    forward forms it, dz = [theta > 0] gs (times P at the winner's source
    row for the support), gs = gb * (1/S).  dz is rounded to bf16 as the
    operand of dd = bf16(rfn)^T dz and of drfn = dz bf16(d)^T (``_mm_g``,
    ``_mm_gp``); the rf chain stays fp32 on the bf16 xyz.  drfn sums its
    exact products in fp64 and is rounded to fp32 once, so that it does not
    depend on the order of the sum (the kernel sums in another).  Returns
    (dverts, dd, dproj): dproj = gs theta at the winner (B, N, K, S*Co),
    zero elsewhere, fp32 and unrounded (support only, else None)."""
    co, K = out_channel, idx.shape[2]
    rf, norm, rfn = _rf_chain_fast(vertices, idx)
    rfn, dirs = _bf16(rfn), _bf16(dirs)
    gs = _per_support(gb, support_num, True)
    drfn = torch.zeros(rf.shape, dtype=torch.float64, device=rf.device)
    dd = torch.zeros_like(dirs)
    dproj = None if proj is None else torch.zeros(idx.shape + (dirs.shape[1],),
                                                  dtype=torch.float32, device=rf.device)
    for s in range(support_num):
        cols = slice(s * co, (s + 1) * co)
        d = dirs[:, cols]
        theta = _theta_fast(rfn, d)
        dprod = _onehot(win[..., cols], K) * gs[:, :, None, :]
        if proj is None:
            dz = torch.where(theta > 0, dprod, 0.0)
        else:
            dz = torch.where(theta > 0, dprod * gather_neighbors(proj[..., cols], idx), 0.0)
            dproj[..., cols] = dprod * theta
        dz = _bf16(dz)
        drfn = drfn + dz.double() @ d.double().t()
        dd[:, cols] = rfn.reshape(-1, 3).t() @ dz.reshape(-1, co)
    return _dverts(_rf_grad_fast(rf, norm, drfn.float()), idx, True), dd, dproj


def hs_surface_fused_bwd_plain(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                               win: torch.Tensor, gb: torch.Tensor, support_num: int,
                               out_channel: int, exact: bool = True):
    """Cotangents (dverts, dd) of ``hs_surface_fused_fwd_plain`` for the
    output cotangent gb (B, N, Co): gb / S routed to each column's winner
    where theta > 0 (pallas_hs_fused.py:524-541).  ``exact=False``: the
    bf16 tier (``_fused_bwd_fast``); both stay fp32."""
    if not exact:
        return _fused_bwd_fast(vertices, idx, dirs, win, gb, support_num, out_channel)[:2]
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
    (B, N, S*Co) fp32 is the backward's residual.  bf16 ``feature_map``: the
    bf16 tier's roundings, as ``hs_support_plain``."""
    exact = feature_map.dtype != torch.bfloat16
    if exact:
        rf = neighbor_directions_normalized(vertices, idx)
        proj = feature_map @ weights + bias
    else:
        rf, dirs = _rf_fast(vertices, idx), _bf16(dirs)
        proj = feature_map.float() @ _bf16(weights) + bias
    total, wins = 0.0, []
    for s in range(support_num):
        cols = slice(s * out_channel, (s + 1) * out_channel)
        theta = torch.relu(rf @ dirs[:, cols]) if exact else _theta_fast(rf, dirs[:, cols])
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
    from dproj scattered to its source rows.  bf16 ``feature_map``: the bf16
    tier (``_support_fused_bwd_fast``), dfeat bf16, the rest fp32."""
    if feature_map.dtype == torch.bfloat16:
        return _support_fused_bwd_fast(feature_map, vertices, idx, weights, dirs, win, proj, gb,
                                       support_num, out_channel)
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


def _support_fused_bwd_fast(feature_map, vertices, idx, weights, dirs, win, proj, gb,
                            support_num: int, out_channel: int):
    """``hs_support_fused_bwd_plain`` of the bf16 tier (``exact=False``,
    pallas_hs_fused.py:463-490): dverts and dd from ``_fused_bwd_fast``; db
    sums dproj unrounded; per (query, k) row, dg = bf16(dproj) bf16(W)^T is
    rounded to bf16 before the source-row sum (``_mm_gp``,
    ``_scatter_rows``), and dfeat is that sum rounded to bf16 (the VJP's
    cast to the feature dtype); dW = g^T bf16(dproj), taken as feat^T times
    the source-row sum of bf16(dproj) (the same products).  The row dg sums
    its exact products in fp64 and rounds to fp32, then to bf16, so that the
    row's rounding does not depend on the order of the sum."""
    B, N, K = idx.shape
    dverts, dd, dproj = _fused_bwd_fast(vertices, idx, dirs, win, gb, support_num, out_channel,
                                        proj)
    dproj_op = _bf16(dproj)
    dg = _bf16((dproj_op.double() @ _bf16(weights).double().t()).float())  # (B, N, K, Cin)
    dfeat = _scatter_rows(dg, idx).to(torch.bfloat16)
    dproj_src = _scatter_rows(dproj_op, idx)
    cin = feature_map.shape[2]
    dw = feature_map.float().reshape(-1, cin).t() @ dproj_src.reshape(B * N, -1)
    return dfeat, dverts, dw, dproj.sum((0, 1, 2)), dd


def orl_global_fused_fwd_plain(feature: torch.Tensor, idx: torch.Tensor):
    """(``orl_global_plain``'s output, win): win (B, N, C) int32 holds the
    first k reaching each channel's max (for bf16 features the maxima are
    bf16 values, the mean fp32)."""
    m, win = _first_max(gather_neighbors(feature, idx))
    return m.float().mean(dim=1, keepdim=True), win.to(torch.int32)


def orl_global_fused_bwd_plain(idx: torch.Tensor, win: torch.Tensor, gb: torch.Tensor,
                               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dfeat (B, N, C) of ``orl_global_fused_fwd_plain`` for the output
    cotangent gb (B, 1, C): gb / N at each (point, channel)'s winning
    neighbour, counted per source row (pallas_hs_fused.py:557-570).
    ``dtype`` bf16 is the bf16 tier: each entry's gb * (1/N) is rounded to
    bf16 before the source-row sum (``_scatter_rows``), and the sum, exact
    in fp32, is rounded to bf16."""
    B, N, K = idx.shape
    C = win.shape[-1]
    counts = _scatter_rows(torch.stack([(win == k).float() for k in range(K)], 2), idx)
    if dtype == torch.bfloat16:
        return (counts * _bf16(_per_support(gb.reshape(B, 1, C), N, True))).to(dtype)
    return counts * (gb.reshape(B, 1, C) / N)


# --------------------------------------------------------------------------- #
# the differentiable ops: kernel wrappers and autograd
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
                         support_num: int, out_channel: int, exact: bool = True):
    """K2 with winners: see ``hs_surface_fused_fwd_plain``."""
    if _build.on_cpu(vertices, idx, dirs):
        return hs_surface_fused_fwd_plain(vertices, idx, dirs, support_num, out_channel, exact)
    S, co = support_num, out_channel
    B, N, K = _check_fused(vertices, idx, dirs, S, co)
    out, win = _empty((B, N, co), vertices), _empty((B, N, S * co), vertices, torch.int32)
    _build.launch("hs_surface_win", vertices, idx, dirs, out, win, B, N, K, S, co, int(not exact))
    _count(hs_surface_fused_fwd, not exact)
    return out, win


def hs_surface_fused_bwd(vertices: torch.Tensor, idx: torch.Tensor, dirs: torch.Tensor,
                         win: torch.Tensor, gb: torch.Tensor, support_num: int,
                         out_channel: int, exact: bool = True):
    """K9: see ``hs_surface_fused_bwd_plain``."""
    if _build.on_cpu(vertices, idx, dirs, win, gb):
        return hs_surface_fused_bwd_plain(vertices, idx, dirs, win, gb, support_num, out_channel,
                                          exact)
    S, co = support_num, out_channel
    B, N, K = _check_fused(vertices, idx, dirs, S, co)
    _build.check(win, "win", torch.int32, (B, N, S * co))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    parts = _build.load().hs_fused_bwd_parts(B, N)
    dverts, red = _empty((B, N, 3), vertices), _empty((3, S * co), vertices)
    _build.launch("hs_surface_fused_bwd", vertices, idx, dirs, win, gb,
                  _empty((B, N, K, 3), vertices), _empty((B, N, 3), vertices),
                  _empty((parts, 3, S * co), vertices), dverts, red, B, N, K, S, co,
                  int(not exact))
    _count(hs_surface_fused_bwd, not exact)
    return dverts, red


def _check_feat(feature_map: torch.Tensor, B: int, N: int) -> bool:
    """Check fp32 or bf16 features (B, N, Cin); True for bf16 (the bf16 tier)."""
    fast = feature_map.dtype == torch.bfloat16
    _build.check(feature_map, "feature_map", torch.bfloat16 if fast else torch.float32,
                 (B, N, None))
    return fast


def hs_support_fused_fwd(feature_map: torch.Tensor, vertices: torch.Tensor, idx: torch.Tensor,
                         weights: torch.Tensor, bias: torch.Tensor, dirs: torch.Tensor,
                         support_num: int, out_channel: int):
    """K3 with winners: see ``hs_support_fused_fwd_plain``."""
    tensors = (feature_map, vertices, idx, weights, bias, dirs)
    if _build.on_cpu(*tensors):
        return hs_support_fused_fwd_plain(*tensors, support_num, out_channel)
    S, co = support_num, out_channel
    B, N, K = _check_fused(vertices, idx, dirs, S, co)
    fast = _check_feat(feature_map, B, N)
    cin = feature_map.shape[2]
    _build.check_rows(weights, "weights", (cin, S * co))
    _build.check(bias, "bias", torch.float32, (S * co,))
    proj = _support_project(feature_map, weights, bias, S, co, fast)
    out, win = _empty((B, N, co), vertices), _empty((B, N, S * co), vertices, torch.int32)
    _build.launch("hs_support_reduce_win", proj, vertices, idx, dirs, out, win, B, N, K, S, co,
                  int(fast))
    _count(hs_support_fused_fwd, fast)
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
    fast = _check_feat(feature_map, B, N)
    cin, sc = feature_map.shape[2], S * co
    _build.check_rows(weights, "weights", (cin, sc))
    _build.check(win, "win", torch.int32, (B, N, sc))
    _build.check(proj, "proj", torch.float32, (B, N, sc))
    _build.check(gb, "gb", torch.float32, (B, N, co))
    lib = _build.load()
    rowptr, ent = _inverse_lists(idx)
    dfeat, dverts = _empty((B, N, cin), vertices, feature_map.dtype), _empty((B, N, 3), vertices)
    dw, red = _empty((cin, sc), vertices), _empty((4, sc), vertices)
    # the bf16 tier's per-(query, k) rows of dfeat (scratch)
    dg = _empty((B, N, K, cin), vertices, torch.bfloat16) if fast else None
    _build.launch("hs_support_fused_bwd", feature_map, weights, weights.stride(0), vertices, idx,
                  dirs, win, proj, gb, rowptr, ent, *(_empty((B, N, sc), vertices) for _ in "zps"),
                  _empty((B, N, K, 3), vertices), _empty((B, N, 3), vertices),
                  _empty((lib.hs_fused_bwd_parts(B, N), 4, sc), vertices),
                  _empty((lib.hs_support_fused_dw_parts(B * N), cin, sc), vertices),
                  0 if dg is None else dg,
                  dfeat, dverts, dw, red, B, N, K, cin, S, co, int(fast))
    _count(hs_support_fused_bwd, fast)
    return dfeat, dverts, dw, red[3], red[:3]


def orl_global_fused_fwd(feature: torch.Tensor, idx: torch.Tensor):
    """K4 with winners: see ``orl_global_fused_fwd_plain``."""
    if _build.on_cpu(feature, idx):
        return orl_global_fused_fwd_plain(feature, idx)
    fast = feature.dtype == torch.bfloat16
    _build.check(feature, "feature", torch.bfloat16 if fast else torch.float32,
                 (None, None, None))
    B, N, C = feature.shape
    K = _check_idx(idx, B, N)
    if K > 32:
        raise ValueError(f"the fused backwards take K <= 32, got K={K}")
    out, win = _empty((B, 1, C), feature), _empty((B, N, C), feature, torch.int32)
    _launch_orl("hs_orl_win", feature, int(fast), idx, out, win, B, N, K, C)
    _count(orl_global_fused_fwd, fast)
    return out, win


def orl_global_fused_bwd(idx: torch.Tensor, win: torch.Tensor, gb: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K10: see ``orl_global_fused_bwd_plain``; ``dtype`` is the features'."""
    if _build.on_cpu(idx, win, gb):
        return orl_global_fused_bwd_plain(idx, win, gb, dtype)
    B, N, K = idx.shape
    _build.check(idx, "idx", torch.int32, (B, N, K))
    _build.check(win, "win", torch.int32, (B, N, None))
    C = win.shape[2]
    _build.check(gb, "gb", torch.float32, (B, 1, C))
    fast = dtype == torch.bfloat16
    dfeat = _empty((B, N, C), win, dtype)
    _build.launch("hs_orl_bwd", idx, win, gb, dfeat, B, N, K, C, int(fast))
    _count(orl_global_fused_bwd, fast)
    return dfeat


for _wrapper in (hs_surface_fused_fwd, hs_surface_fused_bwd, hs_support_fused_fwd,
                 hs_support_fused_bwd, orl_global_fused_fwd, orl_global_fused_bwd):
    _wrapper.launches = 0
    _wrapper.bf16_launches = 0


class HSSurfaceFused(torch.autograd.Function):
    """``hs_surface_fused`` differentiable in vertices and dirs."""

    @staticmethod
    def forward(ctx, vertices, idx, dirs, support_num: int, out_channel: int, exact: bool = True):
        out, win = hs_surface_fused_fwd(vertices, idx, dirs, support_num, out_channel, exact)
        ctx.save_for_backward(vertices, idx, dirs, win)
        ctx.sizes = (support_num, out_channel, exact)
        return out

    @staticmethod
    def backward(ctx, gout):
        vertices, idx, dirs, win = ctx.saved_tensors
        dverts, dd = hs_surface_fused_bwd(vertices, idx, dirs, win, gout.contiguous(),
                                          *ctx.sizes)
        need = ctx.needs_input_grad
        return dverts if need[0] else None, None, dd if need[2] else None, None, None, None


class HSSupportFused(torch.autograd.Function):
    """``hs_support_fused`` differentiable in feature_map, vertices, weights,
    bias and dirs; dfeat in the features' dtype."""

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
    """``orl_global_fused`` differentiable in feature; dfeat in its dtype."""

    @staticmethod
    def forward(ctx, feature, idx):
        out, win = orl_global_fused_fwd(feature, idx)
        ctx.save_for_backward(idx, win)
        ctx.dtype = feature.dtype
        return out

    @staticmethod
    def backward(ctx, gout):
        idx, win = ctx.saved_tensors
        dfeat = orl_global_fused_bwd(idx, win, gout.contiguous(), ctx.dtype)
        return dfeat if ctx.needs_input_grad[0] else None, None
