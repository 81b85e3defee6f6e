"""Category tables: names, symmetry flags, mean shapes (a copy of
``hspose_tpu/geometry/symmetry.py``, which the port cannot import).

The reference scatters these through ``datasets/load_data.py`` (``get_fs_net_scale``
:347-413, ``get_sym_info`` :415-437) and special-cases mug/bowl by raw obj-id in the
losses.  Here they live in one place (SURVEY.md §7 'centralize into the symmetry/
category table').

Category ids are 0-based on the network path: 0 bottle, 1 bowl, 2 camera, 3 can,
4 laptop, 5 mug (the NOCS class ids are these + 1 with 0 = background).
"""

from __future__ import annotations

import numpy as np

CAT_NAMES = ("bottle", "bowl", "camera", "can", "laptop", "mug")
SYNSET_NAMES = ("BG",) + CAT_NAMES  # NOCS 1-based class list incl. background
CAT_NAME2ID = {n: i + 1 for i, n in enumerate(CAT_NAMES)}  # NOCS 1-based
SHAPENET_SYNSET = {
    "bottle": "02876657", "bowl": "02880940", "camera": "02942699",
    "can": "02946921", "laptop": "03642806", "mug": "03797390",
}

# Per-category unit (mean-shape) extents in millimetres for the Real categories
# (datasets/load_data.py:355-385) and the CAMERA synset variants (:386-409).
MEAN_SHAPE_REAL_MM = {
    "bottle": (87.0, 220.0, 89.0),
    "bowl": (165.0, 80.0, 165.0),
    "camera": (88.0, 128.0, 156.0),
    "can": (68.0, 146.0, 72.0),
    "laptop": (346.0, 200.0, 335.0),
    "mug": (146.0, 83.0, 114.0),
}
MEAN_SHAPE_CAMERA_MM = {
    "02876657": (324 / 4, 874 / 4, 321 / 4),
    "02880940": (675 / 4, 271 / 4, 675 / 4),
    "02942699": (464 / 4, 487 / 4, 702 / 4),
    "02946921": (450 / 4, 753 / 4, 460 / 4),
    "03642806": (581 / 4, 445 / 4, 672 / 4),
    "03797390": (670 / 4, 540 / 4, 497 / 4),
}


def mean_shape_mm(cat_name: str) -> np.ndarray:
    """Unit-shape extents in mm for a category name or ShapeNet synset id."""
    if cat_name in MEAN_SHAPE_REAL_MM:
        return np.array(MEAN_SHAPE_REAL_MM[cat_name], dtype=np.float32)
    if cat_name in MEAN_SHAPE_CAMERA_MM:
        return np.array(MEAN_SHAPE_CAMERA_MM[cat_name], dtype=np.float32)
    raise KeyError(f"unknown category {cat_name!r}")


def sym_info(cat_name: str, mug_handle: int = 1) -> np.ndarray:
    """4-vector symmetry descriptor (datasets/load_data.py:415-437).

    c0: 0 no axis symmetry / 1 y-axis symmetry; c1..c3: reflection symmetry about the
    xy / xz / yz planes respectively.
    """
    table = {
        "bottle": (1, 1, 0, 1),
        "bowl": (1, 1, 0, 1),
        "camera": (0, 0, 0, 0),
        "can": (1, 1, 1, 1),
        "laptop": (0, 1, 0, 0),
    }
    if cat_name == "mug":
        vals = (0, 1, 0, 0) if mug_handle == 1 else (1, 0, 0, 0)
    elif cat_name in table:
        vals = table[cat_name]
    else:
        vals = (0, 0, 0, 0)
    return np.array(vals, dtype=np.int32)


def fs_net_scale(cat_name: str, model: np.ndarray, nocs_scale: float):
    """FS-Net scale residual vs the per-category mean shape, in **metres**.

    Matches ``datasets/load_data.py:347-413`` (which returns mm; the caller divides by
    1000 at :268-269 — we fold that in here).
    """
    extents = (model.max(axis=0) - model.min(axis=0)) * nocs_scale * 1000.0
    unit = mean_shape_mm(cat_name)
    return ((extents - unit) / 1000.0).astype(np.float32), (unit / 1000.0).astype(np.float32)


# y-axis-rotation-symmetric classes for the NOCS metrics (evaluation/eval_utils_v1.py:69,140)
IOU_Y_SYMMETRIC = frozenset({"bottle", "bowl", "can"})


def mean_shapes_table_m() -> np.ndarray:
    """(6, 3) mean shapes in metres indexed by 0-based category id (Real names)."""
    return np.stack([mean_shape_mm(n) for n in CAT_NAMES]).astype(np.float32) / 1000.0


def sym_info_table(mug_handle: int = 1) -> np.ndarray:
    """(6, 4) symmetry table indexed by 0-based category id."""
    return np.stack([sym_info(n, mug_handle) for n in CAT_NAMES])
