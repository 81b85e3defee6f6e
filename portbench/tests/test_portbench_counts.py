"""The FLOP and byte counts at tiny shapes against counts by hand."""

import pytest

from portbench import counts


def test_support_projection_counted_once_per_point():
    # one crop at n = 64 points, k = 4: conv_1 alone differs between the
    # per-point projection (2 n Cin S Co) and bench.py's per-neighbour one
    n, k, s = 64, 4, 7
    whole = counts.model_flops_per_crop(n, k, s)
    (n0, k0), (n1, k1), (n2, k2) = counts.resolutions(n, k)
    assert (n1, k1, n2, k2) == (16, 2, 4, 0)
    per_neighbour = (2 * n0 * k0 * 128 * s * 128 + 2 * n1 * k1 * 128 * s * 256
                     + 2 * n1 * k1 * 256 * s * 256 + 2 * n2 * k2 * 256 * s * 512)
    per_point = (2 * n0 * 128 * s * 128 + 2 * n1 * 128 * s * 256 + 2 * n1 * 256 * s * 256
                 + 2 * n2 * 256 * s * 512)
    assert per_point == 2 * 7 * (64 * 128 * 128 + 16 * 128 * 256 + 16 * 256 * 256 + 4 * 256 * 512)
    heads = sum(2 * n * (c * 1024 + 1024 * 256) + 2 * (256 * 256 + 256 * o)
                for c, o in ((1286, 4), (1286, 4), (1289, 6)))
    knn = (2 * 64 * 64 * 3 * 2 + 2 * 64 * 64 * 128 + 2 * 16 * 16 * 3 * 2 + 2 * 16 * 16 * 128
           + 2 * 16 * 16 * 256 + 2 * 4 * 4 * 3 + 2 * 4 * 4 * 256 + 2 * 64 * 16 * 3 + 2 * 64 * 4 * 3)
    theta = 2 * 3 * s * (64 * 4 * 128 + 64 * 4 * 128 + 16 * 2 * 256 + 16 * 2 * 256 + 0)
    dense = (2 * 64 * 3 * 128 + 2 * 64 * 256 * 128  # conv_0: STE, conv2
             + sum(2 * nn * cin * co * 2 + 2 * nn * 2 * co * co
                   for nn, cin, co in ((64, 128, 128), (16, 128, 256), (16, 256, 256), (4, 256, 512))))
    assert whole == per_point + heads + knn + theta + dense
    assert per_neighbour > per_point


def test_train_flops_are_three_forwards_with_the_train_heads():
    n = 32
    heads = 2 * n * (1286 * 512 + 512 * 512 + 512 * 256 + 256 * 128 + 128 * 3
                     + 771 * 512 + 512 * 256 + 256 * 128 + 128 * 30)
    assert counts.train_flops_per_sample(n, 4) == 3 * (counts.model_flops_per_crop(n, 4) + heads)


def test_kernel_ops_at_tiny_shapes():
    B, n, k, s = 2, 64, 4, 7
    ops = {op.name: op for op in counts.kernel_ops(B, n, k, s, "float32", train=False)}
    assert len(ops) == 9 + 1 + 4 + 5
    assert ops["knn_v0"] == counts.Op("knn_v0", 2 * B * 64 * 64 * 3, 0, B * 64 * 3 * 4 + B * 64 * 4 * 4)
    assert ops["knn_f1"].flops_tier == 2 * B * 64 * 64 * 128 and ops["knn_f1"].flops32 == 0
    assert ops["hs_surface"].flops32 == 2 * 3 * B * 64 * 4 * 7 * 128
    assert ops["hs_surface"].nbytes == (B * 64 * 3 + B * 64 * 4 + 3 * 7 * 128 + B * 64 * 128) * 4
    sup = ops["hs_support_2"]  # 16 points, k 2, 128 -> 256
    assert sup.flops_tier == 2 * B * 16 * 128 * 7 * 256
    assert sup.flops32 == 2 * 3 * B * 16 * 2 * 7 * 256 + B * 16 * 2 * 7 * 256
    assert sup.nbytes == (B * 16 * 128 + B * 16 * 3 + B * 16 * 2 + 128 * 7 * 256 + 4 * 7 * 256
                          + B * 16 * 256) * 4
    assert ops["orl_4"].nbytes == B * 4 * 512 * 4 + B * 4 * 0 * 4 + B * 512 * 4
    bf = {op.name: op for op in counts.kernel_ops(B, n, k, s, "bfloat16", train=False)}
    assert bf["orl_1"].nbytes == B * 64 * 128 * 2 + B * 64 * 4 * 4 + B * 128 * 4
    train = {op.name for op in counts.kernel_ops(B, n, k, s, "float32", train=True)}
    assert "orl_0" not in train and {"hs_surface_bwd", "hs_support_4_bwd"} <= train


def test_least_time_is_the_larger_bound():
    op = counts.Op("x", 67e9, 989e9, 3.35e9)  # 1 ms of fp32, 1 ms of bf16, 1 ms of bytes
    assert counts.least_seconds(op, "bfloat16") == pytest.approx(2e-3)
    assert counts.least_seconds(counts.Op("y", 0, 0, 3.35e12), "float32") == pytest.approx(1.0)
