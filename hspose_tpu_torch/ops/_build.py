"""Build and load the port's CUDA kernels (``hspose_tpu_torch/csrc/*.cu``).

At first use, ``nvcc`` compiles every source into one shared library with a
plain C interface, ``build/hspose_tpu_torch/libhspose_kernels-<sha>.so`` under
the repository root, named by a hash of the sources so an edit rebuilds.  The
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
              "-shared", "-Xcompiler", "-fPIC"]
# ptxas reports each kernel's registers, shared memory and spills into the
# build log kept beside the library (<library>.log)
PTXAS_REPORT = "-Xptxas=-v"

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    # points, out, B, N, D, kk, stream
    "hs_knn": [_P, _P, _I, _I, _I, _I, _P],
    # verts, idx, dirs, out, B, N, K, S, Co, stream
    "hs_surface": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # feat, w, ldw, b, proj, rows, Cin, Cout, stream
    "hs_support_project": [_P, _P, _I, _P, _P, _I, _I, _I, _P],
    # proj, verts, idx, dirs, out, B, N, K, S, Co, stream
    "hs_support_reduce": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # feat, idx, partial, out, B, N, K, C, stream
    "hs_orl": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # N -> tiles of the ORL partial-sum scratch (no launch)
    "hs_orl_tiles": [_I],
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
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    # write to a private name, then rename: concurrent processes never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, PTXAS_REPORT, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stderr)
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
