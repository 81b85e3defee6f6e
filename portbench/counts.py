"""Operations and bytes of the model and of the port's kernels, from the
cell's shapes alone, and the card's peaks.

* ``model_flops_per_crop`` / ``train_flops_per_sample``: a plain-Python copy
  of ``bench.py:47-91`` and ``:145-152`` (the JAX package's count of one
  eval crop's and one training sample's matrix FLOPs), with two
  corrections: the HS support projection is counted once per point,
  2 N Cin S Co (the op projects each point and then gathers), not once per
  neighbour, 2 N K Cin S Co (``bench.py:75`` counted 4.7 GFLOP at conv_1
  where the op needs 0.27); and each head's last layer has its own width
  (4, 4, 6) where ``bench.py:90`` took 8.  The peaks are an H100's, not a
  v5e's (``bench.py:43-44``).
* ``least_seconds``: ``chip_smoke.py::bound`` (``chip_smoke.py:466-473``):
  the larger of an op's bytes (each input read once, each output written
  once) over the HBM rate and its operations over the peak of their type;
  the bytes and operations are those the op needs at the cell's shapes,
  not those of the tensors a launch happens to be given, so a redesign that
  passes other tensors leaves the yardstick as it is.
* ``kernel_ops``: the searches and HS reductions of one forward (serving)
  or one train step (forward and backward) that the port's kernels do:
  the nine KNN searches, the HS surface reduction, the four HS support
  projections and reductions and, when serving, the five ORL reductions
  (in training the ORL branch is PyTorch's gather, max and mean).

Peaks: NVIDIA's data sheet for the H100 SXM, dense: 67 TFLOP/s float32 off
the tensor cores (TF32 off, as the port runs), 989 TFLOP/s bfloat16,
3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import List, NamedTuple

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
FEAT_C = 128 + 128 + 256 + 256 + 512


class Op(NamedTuple):
    """One op's work: FLOPs at the float32 peak, FLOPs at the tier's peak
    (tensor-core products), and bytes."""

    name: str
    flops32: float
    flops_tier: float
    nbytes: float


def least_seconds(op: Op, dtype: str) -> float:
    compute = op.flops32 / PEAK_FLOPS["float32"] + op.flops_tier / PEAK_FLOPS[dtype]
    return max(compute, op.nbytes / HBM_BYTES_PER_S)


def resolutions(n: int, k: int):
    """(points, neighbours) at the three resolutions of the backbone."""
    n1, n2 = n // 4, n // 16
    return (n, k), (n1, min(k, n1 // 8)), (n2, min(k, n2 // 8))


def model_flops_per_crop(n: int = 1028, k: int = 20, s: int = 7, obj_c: int = 6) -> float:
    """Matrix FLOPs of one eval crop: the KNN distances' inner products, the
    HS theta contractions and projections, the centre / STE / conv2 dense
    maps, the 1-NN upsample distances and the three pose heads."""
    (n0, k0), (n1, k1), (n2, k2) = resolutions(n, k)

    def knn_dist(nn, d):
        return 2 * nn * nn * d

    fl = knn_dist(n0, 3) * 2 + knn_dist(n0, 128)
    fl += knn_dist(n1, 3) * 2 + knn_dist(n1, 128) + knn_dist(n1, 256)
    fl += knn_dist(n2, 3) + knn_dist(n2, 256)
    fl += 2 * n0 * n1 * 3 + 2 * n0 * n2 * 3

    def hs(nn, kk, cin, co, surface=False):
        f = 2 * nn * kk * 3 * s * co  # theta
        if not surface:
            f += 2 * nn * cin * s * co  # support projection, once per point
            f += 2 * nn * cin * co  # feature_center
        f += 2 * nn * cin * co  # STE
        f += 2 * nn * (2 * co) * co  # conv2 on [feature | global]
        return f

    fl += hs(n0, k0, 3, 128, surface=True)
    fl += hs(n0, k0, 128, 128)
    fl += hs(n1, k1, 128, 256)
    fl += hs(n1, k1, 256, 256)
    fl += hs(n2, k2, 256, 512)
    feat_c = FEAT_C + obj_c
    for in_c, out in ((feat_c, 4), (feat_c, 4), (feat_c + 3, 6)):
        fl += 2 * n0 * (in_c * 1024 + 1024 * 256) + 2 * (256 * 256 + 256 * out)
    return float(fl)


def train_flops_per_sample(n: int = 1028, k: int = 20, s: int = 7, obj_c: int = 6,
                           face_c: int = 30) -> float:
    """3x the eval forward (forward and a backward of twice its work) plus
    3x the train-only conv1d, recon and face heads."""
    feat_c = FEAT_C + obj_c
    head = 2 * n * (feat_c * 512 + 512 * 512 + 512 * 256)
    head += 2 * n * (256 * 128 + 128 * 3)
    head += 2 * n * (771 * 512 + 512 * 256 + 256 * 128 + 128 * face_c)
    return 3.0 * (model_flops_per_crop(n, k, s, obj_c) + head)


def kernel_ops(B: int, n: int, k: int, s: int, dtype: str, train: bool) -> List[Op]:
    """The port's kernel work of one forward (serving) or one train step."""
    es = 2 if dtype == "bfloat16" else 4  # bytes of a feature element
    (n0, k0), (n1, k1), (n2, k2) = resolutions(n, k)
    ops: List[Op] = []
    # the nine searches: xyz in fp32, features in the tier's type (the bf16
    # tier's feature searches run on the tensor cores)
    for name, nn, d, kk in (("knn_v0", n0, 3, k0), ("knn_f1", n0, 128, k0), ("knn_p0", n0, 3, 4),
                            ("knn_v1", n1, 3, k1), ("knn_f2", n1, 128, k1), ("knn_f3", n1, 256, k1),
                            ("knn_p1", n1, 3, 4), ("knn_v2", n2, 3, k2), ("knn_f4", n2, 256, k2)):
        fl = 2.0 * B * nn * nn * d
        feature = d > 3
        ops.append(Op(name, 0.0 if feature else fl, fl if feature else 0.0,
                      B * nn * d * (es if feature else 4) + B * nn * kk * 4))
    # HS surface reduction (conv_0): theta over every (neighbour, support, channel)
    co = 128
    theta = 2.0 * 3 * B * n0 * k0 * s * co
    ops.append(Op("hs_surface", theta, 0.0,
                  B * n0 * 3 * 4 + B * n0 * k0 * 4 + 3 * s * co * 4 + B * n0 * co * 4))
    if train:
        ops.append(Op("hs_surface_bwd", theta, 0.0, B * n0 * co * 4 + B * n0 * 3 * 4))
    # HS support projection and reduction (conv_1 .. conv_4)
    for name, nn, kk, cin, co in (("hs_support_1", n0, k0, 128, 128),
                                  ("hs_support_2", n1, k1, 128, 256),
                                  ("hs_support_3", n1, k1, 256, 256),
                                  ("hs_support_4", n2, k2, 256, 512)):
        proj = 2.0 * B * nn * cin * s * co
        red = 2.0 * 3 * B * nn * kk * s * co + B * nn * kk * s * co
        nbytes = (B * nn * cin * es + B * nn * 3 * 4 + B * nn * kk * 4 + cin * s * co * 4
                  + 4 * s * co * 4 + B * nn * co * 4)
        ops.append(Op(name, red, proj, nbytes))
        if train:
            ops.append(Op(name + "_bwd", red, 2 * proj,
                          B * nn * co * 4 + B * nn * cin * es + cin * s * co * 4))
    if not train:
        for name, nn, kk, c in (("orl_0", n0, k0, 128), ("orl_1", n0, k0, 128),
                                ("orl_2", n1, k1, 256), ("orl_3", n1, k1, 256),
                                ("orl_4", n2, k2, 512)):
            ops.append(Op(name, 0.0, 0.0, B * nn * c * es + B * nn * kk * 4 + B * c * 4))
    return ops


def kernel_least_seconds(B: int, n: int, k: int, s: int, dtype: str, train: bool) -> float:
    return sum(least_seconds(op, dtype) for op in kernel_ops(B, n, k, s, dtype, train))
