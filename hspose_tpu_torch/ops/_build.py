"""Build and load the port's CUDA kernels (``hspose_tpu_torch/csrc/*.cu``).

At first use, ``nvcc`` compiles every source, one process per file, all
started together, and links the objects into one shared library with a plain
C interface, ``build/hspose_tpu_torch/libhspose_kernels-<sha>.so`` under the
repository root, named by a hash of the sources so an edit rebuilds.  The
library is loaded with ``ctypes``; each entry point takes device pointers,
int sizes and the CUDA stream, launches without synchronising, and returns
``cudaGetLastError()``.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hspose_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
# ptxas reports each kernel's registers, shared memory and spills into the
# build log kept beside the library (<library>.log)
PTXAS_REPORT = "-Xptxas=-v"

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    # points, out, B, N, D, kk, lanes, stream
    "hs_knn": [_P, _P, _I, _I, _I, _I, _I, _P],
    # points, is_bf16, out, B, N, D, kk, lanes, stream
    "hs_knn_packed": [_P, _I, _P, _I, _I, _I, _I, _I, _P],
    # the query-sharded branches (sequence-parallel serving): queries against
    # the M source rows that contain them
    # queries, points, out, B, NQ, M, D, kk, lanes, stream
    "hs_knn_qs": [_P, _P, _P] + [_I] * 6 + [_P],
    # queries, points, is_bf16, out, B, NQ, M, D, kk, lanes, stream
    "hs_knn_packed_qs": [_P, _P, _I, _P] + [_I] * 6 + [_P],
    # verts, vq, idx, dirs, out, B, NQ, M, K, S, Co, fast, stream
    "hs_surface_qs": [_P] * 5 + [_I] * 7 + [_P],
    # proj, verts, vq, idx, dirs, out, B, NQ, M, K, S, Co, fast, stream
    "hs_support_reduce_qs": [_P] * 6 + [_I] * 7 + [_P],
    # feat, fast, idx, out, B, NQ, M, K, C, stream
    "hs_orl_qs": [_P, _I, _P, _P] + [_I] * 5 + [_P],
    # verts, idx, dirs, out, B, N, K, S, Co, fast, stream
    "hs_surface": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # feat, fast, w, ldw, b, proj, rows, Cin, Cout, stream
    "hs_support_project": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _P],
    # proj, verts, idx, dirs, out, B, N, K, S, Co, fast, stream
    "hs_support_reduce": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # feat, fast, idx, out, B, N, K, C, stream
    "hs_orl": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
    # rf, dirs, out, win, B, N, K, S, Co, fast, stream
    "hs_surface_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # rf, dirs, win, gb, drf, partial, dd, B, N, K, S, Co, fast, stream
    "hs_surface_bwd": [_P] * 7 + [_I] * 6 + [_P],
    # B, N -> rows of the surface backward's partial-sum scratch (no launch)
    "hs_surface_bwd_parts": [_I, _I],
    # feat, idx, rf, w, ldw, b, dirs, proj, out, win, twin, pwin, B, N, K, Cin, S, Co, fast,
    # stream
    "hs_support_fwd": [_P] * 4 + [_I] + [_P] * 7 + [_I] * 7 + [_P],
    # g, rf, w, ldw, dirs, win, twin, pwin, gb, dg, drf, partial, red,
    # B, N, K, Cin, S, Co, fast, stream
    "hs_support_bwd": [_P, _P, _P, _I] + [_P] * 9 + [_I] * 7 + [_P],
    # B * N -> rows of the support backward's partial-sum scratch (no launch)
    "hs_support_bwd_parts": [_I],
    # K, Cin, Co -> 0 when the training support kernels take these sizes (no launch)
    "hs_support_train_supported": [_I, _I, _I],
    # bwd_store=False: feat, idx, rf, w, ldw, b, dirs, proj, out, win, B, N, K, Cin, S, Co,
    # fast, stream
    "hs_support_fwd_win": [_P] * 4 + [_I] + [_P] * 5 + [_I] * 7 + [_P],
    # g, rf, w, ldw, b, dirs, win, gb, twin, pwin, dg, drf, partial, red,
    # B, N, K, Cin, S, Co, fast, stream
    "hs_support_bwd_recompute": [_P, _P, _P, _I] + [_P] * 10 + [_I] * 7 + [_P],
    # the differentiable fused ops: forwards with winners and their backwards
    # verts, idx, dirs, out, win, B, N, K, S, Co, fast, stream
    "hs_surface_win": [_P] * 5 + [_I] * 6 + [_P],
    # verts, idx, dirs, win, gb, drf, dvq, partial, dverts, red, B, N, K, S, Co, fast, stream
    "hs_surface_fused_bwd": [_P] * 10 + [_I] * 6 + [_P],
    # B, N -> rows of the fused backwards' dd (and db) partial-sum scratch (no launch)
    "hs_fused_bwd_parts": [_I, _I],
    # proj, verts, idx, dirs, out, win, B, N, K, S, Co, fast, stream
    "hs_support_reduce_win": [_P] * 6 + [_I] * 6 + [_P],
    # B * N -> slices of the support backward's dW partial-sum scratch (no launch)
    "hs_support_fused_dw_parts": [_I],
    # feat, w, ldw, verts, idx, dirs, win, proj, gb, rowptr, ent, dz, dproj, dproj_src,
    # drf, dvq, partial, dw_partial, dg, dfeat, dverts, dw, red, B, N, K, Cin, S, Co, fast,
    # stream
    "hs_support_fused_bwd": [_P, _P, _I] + [_P] * 20 + [_I] * 7 + [_P],
    # feat, fast, idx, out, win, B, N, K, C, stream
    "hs_orl_win": [_P, _I] + [_P] * 3 + [_I] * 4 + [_P],
    # idx, win, gb, dfeat, B, N, K, C, fast, stream
    "hs_orl_bwd": [_P] * 4 + [_I] * 5 + [_P],
    # chamfer: a, b, dist, B, N, M, stream
    "hs_chamfer_min": [_P] * 3 + [_I] * 3 + [_P],
    # a, b, dist, arg, B, N, M, stream
    "hs_chamfer_min_argmin": [_P] * 4 + [_I] * 3 + [_P],
    # a, b, ia, ib, gda, gdb, ga, B, N, M, stream
    "hs_chamfer_grad": [_P] * 7 + [_I] * 3 + [_P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run, None if cached


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libhspose_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # write to a private name, then rename: concurrent processes never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = str(Path(objdir) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, PTXAS_REPORT, "-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            log.append(" ".join(cmd) + "\n" + err)
            if proc.returncode != 0:
                failed.append(f"{cmd[-3]} ({proc.returncode}):\n{err}")
        if not failed:
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    out.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one entry point on the current stream (pass tensors, ints); raise
    if the launch reported a CUDA error."""
    import torch

    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(load(), name)(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain versions run);
    False when all are CUDA tensors (the kernel runs); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA device, "
                     f"got {[str(t.device) for t in tensors]}")


def check(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` has ``dtype``, is contiguous and matches ``shape``
    (None matches any size)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.dim() != len(shape) or any(s is not None and s != d
                                    for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def check_rows(t, name: str, shape: tuple) -> None:
    """Raise unless ``t`` is fp32 of ``shape`` (rows, cols) with each row
    contiguous: a column slice of a wider matrix passes, with its row stride
    given to the kernel."""
    import torch

    rows, cols = shape
    if (t.dtype != torch.float32 or tuple(t.shape) != (rows, cols)
            or t.stride(1) != 1 or t.stride(0) < cols):
        raise ValueError(f"{name}: expected fp32 ({rows}, {cols}) with contiguous rows, "
                         f"got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
