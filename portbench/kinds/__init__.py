"""One module per traffic kind, found by the ``kind`` of a traffic file:
``portbench/kinds/<kind>.py``.  A kind's module drives the program under a
mix of its kind and checks what the window produced.  It has

* ``run(cell, seed, seconds, trace, device, t_process) -> common.Outcome``:
  one run of a cell, ``t_process`` being the process's start on the
  ``time.perf_counter`` clock;
* ``CHIPS``: the most cards one run drives.  ``run.py`` refuses a cell that
  asks for more, so a cell on four chips needs a kind that starts a rank on
  each.

A new kind (an open loop, the train CLI on a rendered tree) is a new module
here; the traffic files of the mixes it generates then name it.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import ModuleType

DIR = Path(__file__).resolve().parent
KIND = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")  # a module's name


def load(kind: str) -> ModuleType:
    """The module of traffic kind ``kind``."""
    if not KIND.match(kind) or not (DIR / f"{kind}.py").is_file():
        raise KeyError(f"traffic kind {kind!r} has no module portbench/kinds/{kind}.py")
    return importlib.import_module(f"portbench.kinds.{kind}")
