"""The ctypes signatures of ``hspose_tpu_torch/ops/_build.py::SIGNATURES``
against the ``extern "C"`` entry points of ``hspose_tpu_torch/csrc/*.cu``.

ctypes does not check a call against the C function it reaches: an argument
missing, added or of the wrong kind (an int where the source takes a
pointer, which ctypes cuts to 32 bits) shows only as a fault on the card.
No CPU run reaches the kernels, so this test reads the sources: for every
entry point, the parameters in order, each a pointer (``c_void_p``) or an
int (``c_int``), must be those ``SIGNATURES`` declares, and every declared
entry point must exist in a source.
"""

import ctypes
import re

import pytest

from hspose_tpu_torch.ops import _build

ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def entry_points() -> dict[str, list[str]]:
    """Entry point -> parameter kinds in order ("pointer" or "int"), from the
    sources; a name defined twice is an error."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, params in ENTRY.findall(path.read_text()):
            assert name not in found, f"{name} is defined twice"
            kinds = []
            for p in filter(None, (x.strip() for x in params.split(","))):
                if "*" in p:
                    kinds.append("pointer")
                elif re.fullmatch(r"(const\s+)?int\s+\w+", p):
                    kinds.append("int")
                else:
                    raise AssertionError(f"{name}: parameter {p!r} is neither a pointer nor an int")
            found[name] = kinds
    return found


SOURCES = entry_points()
NAMES = sorted(set(SOURCES) | set(_build.SIGNATURES))


def kinds(argtypes) -> list[str]:
    out = []
    for t in argtypes:
        if t is ctypes.c_void_p:
            out.append("pointer")
        elif t is ctypes.c_int:
            out.append("int")
        else:
            raise AssertionError(f"argtype {t} is neither c_void_p nor c_int")
    return out


@pytest.mark.parametrize("name", NAMES)
def test_signature_matches_the_source(name):
    assert name in SOURCES, f"{name} is in SIGNATURES but in no csrc/*.cu"
    assert name in _build.SIGNATURES, f"{name} is a C entry point without a ctypes signature"
    want, got = SOURCES[name], kinds(_build.SIGNATURES[name])
    assert len(got) == len(want), f"{name}: {len(got)} argtypes for {len(want)} parameters"
    assert got == want, f"{name}: argtypes {got} against parameters {want}"


def test_every_source_was_read():
    """The parser finds the entry points of every kernel source: each file
    has one, and ORL's are its forward, its query-sharded branch, the
    forward with winners and the backward."""
    files = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert files == {"chamfer", "heads_epilogue", "hs_support", "hs_support_train",
                     "hs_surface", "hs_surface_train", "knn", "orl"}
    for path in _build.CSRC.glob("*.cu"):
        assert ENTRY.search(path.read_text()), f"no entry point found in {path.name}"
    assert {n for n in SOURCES if n.startswith("hs_orl")} == {"hs_orl", "hs_orl_qs", "hs_orl_win",
                                                             "hs_orl_bwd"}
    assert len(SOURCES) >= 26
