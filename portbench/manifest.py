"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
harness reads ``configs`` for the configuration's file, then
``portbench/traffic/<traffic>.json``, whose ``kind`` names the module that
drives it (``portbench/kinds/<kind>.py``), ``portbench/limits/<cell>.json``
(the numbers its check compares and their limits) and, for each metric
that the cell reports, ``portbench/metrics/<metric>.py``.  Adding a cell, a
configuration, a traffic mix, a traffic kind or a metric adds files and
entries and edits no file that is there.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List, Tuple

from portbench.common import Cell

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metrics_of(manifest: dict, section: str, cell: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in manifest[section] if cell in m.get("workloads", [cell])]


def find_cell(manifest: dict, name: str, root: Path = ROOT) -> Tuple[Cell, dict]:
    """(the cell, its workloads entry)."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    pkg = root / "portbench"
    traffic = json.loads((pkg / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["num_points"] = config["data"]["num_points"]
    limits = json.loads((pkg / "limits" / f"{name}.json").read_text())
    return Cell(name, config, traffic, limits["limits"]), w


def problems(manifest: dict, root: Path = ROOT) -> List[str]:
    """What in the manifest breaks the benchmark's naming rules or names a
    file that is not there."""
    out: List[str] = []
    names = ([c["name"] for c in manifest["configs"]]
             + [w["name"] for w in manifest["workloads"]]
             + [m["name"] for s in ("end_to_end", "per_layer") for m in manifest[s]]
             + [w[k] for w in manifest["workloads"] for k in ("config", "traffic")]
             + [k for c in manifest["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    for section in ("configs", "workloads"):
        seen = [x["name"] for x in manifest[section]]
        out += [f"duplicate {section} name {n!r}" for n in set(seen) if seen.count(n) > 1]
    metrics = [m["name"] for s in ("end_to_end", "per_layer") for m in manifest[s]]
    out += [f"duplicate metric {n!r}" for n in set(metrics) if metrics.count(n) > 1]
    for s in ("end_to_end", "per_layer"):
        for m in manifest[s]:
            if not UNIT.match(m["unit"]):
                out.append(f"bad unit {m['unit']!r} of {m['name']}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"bad 'better' of {m['name']}")
            if not (root / "portbench" / "metrics" / f"{m['name']}.py").is_file():
                out.append(f"metric {m['name']} has no reader")
    for c in manifest["configs"]:
        if not (root / c["file"]).is_file():
            out.append(f"configuration {c['name']} has no file {c['file']}")
    for w in manifest["workloads"]:
        pkg = root / "portbench"
        traffic = pkg / "traffic" / f"{w['traffic']}.json"
        for path in (traffic, pkg / "limits" / f"{w['name']}.json"):
            if not path.is_file():
                out.append(f"workload {w['name']} lacks {path.relative_to(root)}")
        if traffic.is_file():
            kind = pkg / "kinds" / f"{json.loads(traffic.read_text())['kind']}.py"
            if not kind.is_file():
                out.append(f"workload {w['name']} lacks {kind.relative_to(root)}")
    return out

