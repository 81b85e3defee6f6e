"""The selection rule of the KNN kernel (``hspose_tpu_torch/csrc/knn.cu``)
against the plain versions, on the CPU, and the wrapper's launch plan.

The kernel splits each query's source points between LANES lanes, keeps per
lane the k+1 smallest by (distance, index), drops candidates above a bound
shared by the query's lanes, and merges the lanes' lists in (distance,
index) order.  Those steps must give exactly ``ops/knn.py::knn_indices``
(and, on packed keys, ``knn_indices_packed``) whatever the split, on clouds
with duplicated points and exact ties.  The tests model them in numpy on
the plain versions' own distances: the kernel's distances are its own, held
to the plain version on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from hspose_tpu_torch.ops import cuda_knn, knn

torch.set_num_threads(2)  # the suite runs several workers on one host

TS = 64  # source points per tile (csrc/knn.cu)


def tied_cloud(rng, B, N, D):
    """Points on a coarse grid, so that many distances tie exactly, with
    duplicated points at higher and at lower indices than their twins."""
    pts = (rng.integers(-3, 4, size=(B, N, D)) / 4.0).astype(np.float32)
    pts[:, N // 2:N // 2 + 10] = pts[:, 10:20]
    pts[:, 5] = pts[:, N - 3]
    return torch.from_numpy(pts)


def distances_and_keys(points):
    """The plain versions' fp32 distances (B, N, N) and packed keys."""
    n = points.shape[1]
    d = knn.pairwise_sq_dist(points, points)
    if points.shape[2] <= 8:  # knn_indices_packed sums squared differences there
        x = points.float()
        d_packed = torch.zeros_like(d)
        for dim in range(points.shape[2]):
            diff = x[:, None, :, dim] - x[:, :, None, dim]
            d_packed = d_packed + diff * diff
    else:
        d_packed = d
    col = torch.arange(n, dtype=torch.int32)
    keys = (d_packed.clamp_min(0.0).view(torch.int32) & ~(knn.PACKED_MAX_N - 1)) | col
    return d.numpy(), keys.numpy().astype(np.int64)


def smallest(values, cols, kk):
    """The kk smallest (value, index) pairs of one query's candidates, in order."""
    order = np.lexsort((cols, values))[:kk]
    return [(values[o], cols[o]) for o in order]


def merge(lists, kk):
    """Merge sorted lists of (value, index) pairs: the kk smallest in order."""
    return sorted((e for lst in lists for e in lst))[:kk]


@pytest.mark.parametrize("split", ["interleaved", "contiguous"])
@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_split_select_merge_equals_the_plain_version(rng, split, parts, packed):
    """Each part's k+1 smallest by (distance, index), merged in that order,
    with column 0 dropped, is the plain version's answer."""
    B, N, D, k = 2, 150, 3, 8
    points = tied_cloud(rng, B, N, D)
    d, keys = distances_and_keys(points)
    want = (knn.knn_indices_packed(points, k) if packed else knn.knn_indices(points, k)).numpy()
    cols = np.arange(N)
    part_of = cols % parts if split == "interleaved" else cols * parts // N
    got = np.empty_like(want)
    for b in range(B):
        for q in range(N):
            vals = keys[b, q] if packed else d[b, q]
            lists = [smallest(vals[part_of == p], cols[part_of == p], k + 1)
                     for p in range(parts)]
            got[b, q] = [i for _, i in merge(lists, k + 1)[1:]]
    np.testing.assert_array_equal(got, want)


def kernel_selection(vals, kk, lanes):
    """The kernel's selection for one query, on candidate values ``vals``
    (distances, or packed keys): lane p scans columns p, p + lanes, ... of
    each tile of TS in increasing index; a candidate is queued if it is
    below the lane's kk-th entry and not above the query's bound (the
    smallest kk-th entry among the lanes after the previous tile); queued
    candidates are inserted in increasing index by a strict '<'; the lanes'
    lists merge in (value, index) order.  Returns the kk indices in order."""
    inf = np.inf
    lists = [[] for _ in range(lanes)]  # sorted (value, index)

    def kth(lst):
        return lst[kk - 1][0] if len(lst) >= kk else inf

    bound = inf
    n = len(vals)
    for s0 in range(0, n, TS):
        start = [kth(lst) for lst in lists]
        for p in range(lanes):
            queued = [j for j in range(s0 + p, min(s0 + TS, n), lanes)
                      if vals[j] < start[p] and vals[j] <= bound]
            for j in queued:
                lst = lists[p]
                pos = next((i for i, (v, _) in enumerate(lst) if vals[j] < v), len(lst))
                lst.insert(pos, (vals[j], j))
                del lst[kk:]
        bound = min(kth(lst) for lst in lists)
    return [i for _, i in merge(lists, kk)]


@pytest.mark.parametrize("lanes", [4, 8, 16])
@pytest.mark.parametrize("N,D,k", [(150, 3, 8), (257, 3, 20), (200, 16, 4), (64, 16, 8)])
@pytest.mark.parametrize("packed", [False, True])
def test_kernel_selection_with_bound_equals_the_plain_version(rng, lanes, N, D, k, packed):
    """The bound filter and the queued insertion drop nothing of the answer:
    the kernel's rule, tile by tile, gives the plain version's indices."""
    B = 1
    points = tied_cloud(rng, B, N, D)
    d, keys = distances_and_keys(points)
    want = (knn.knn_indices_packed(points, k) if packed else knn.knn_indices(points, k)).numpy()
    for q in range(N):
        vals = keys[0, q] if packed else d[0, q]
        got = kernel_selection(vals, k + 1, lanes)[1:]
        np.testing.assert_array_equal(got, want[0, q], err_msg=f"query {q}")


FORWARD_SEARCHES = [  # (N, D, k) of the nine searches of one forward, B = 24, and their lanes
    (1028, 3, 20, 4), (1028, 128, 20, 4), (1028, 3, 4, 8), (257, 3, 20, 16), (257, 128, 20, 4),
    (257, 256, 20, 4), (257, 3, 4, 16), (64, 3, 8, 16), (64, 256, 8, 16)]


@pytest.mark.parametrize("N,D,k,lanes", FORWARD_SEARCHES + [
    (2056, 3, 20, 4), (2056, 128, 20, 4), (2056, 3, 4, 4),
    (4096, 3, 20, 4), (4096, 128, 20, 4), (4096, 3, 4, 4)])
def test_launch_plan(N, D, k, lanes):
    """Four lanes (64 queries per block) for the distance products of D > 8
    where they give half a block per SM; for the xyz searches four where the
    grid fills two blocks per SM, eight for k <= 8 below four blocks per SM,
    else sixteen; what the plan gives stays within the kernel's limits."""
    assert cuda_knn.knn_lanes(24, N, D, k) == lanes
    assert lanes in (4, 8, 16)
    assert D <= cuda_knn.MAX_D and k <= cuda_knn.MAX_K


def test_launch_plan_small_batches():
    """A single cloud takes sixteen lanes: four would leave most of the
    card idle; sixteen clouds of 1028 points fill it with four."""
    assert cuda_knn.knn_lanes(1, 1028, 3, 20) == 16
    assert cuda_knn.knn_lanes(1, 1028, 128, 20) == 16
    assert cuda_knn.knn_lanes(16, 1028, 3, 20) == 4
    assert cuda_knn.knn_lanes(16, 1028, 128, 20) == 4
