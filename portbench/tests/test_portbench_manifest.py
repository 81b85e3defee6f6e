"""BENCHMARK.json against the benchmark's rules, and a cell, a configuration,
a traffic mix and a metric added as files of their own."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import manifest
from portbench.readings import reader

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture
def bench():
    return manifest.load()


def test_names_units_and_files(bench):
    assert set(bench) == TOP
    assert manifest.problems(bench) == []


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entry_keys(bench, section, keys):
    for entry in bench[section]:
        assert set(entry) <= keys, entry["name"]
        assert set(entry) >= keys - {"workloads"}, entry["name"]
        for k in ("why", "layer", "source"):
            if k in entry:
                assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert w["chips"] == 1
        mine = [m["name"] for m in manifest.metrics_of(bench, "end_to_end", w["name"])]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        layer = manifest.metrics_of(bench, "per_layer", w["name"])
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_hold_published_widths(bench):
    for c in bench["configs"]:
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert c["reduced"] == conf["reduced"] == []
        m = conf["model"]
        assert (m["gcn_sup_num"], m["gcn_n_num"], m["obj_c"], m["face_recon_c"],
                conf["data"]["num_points"]) == (7, 20, 6, 30, 1028)


def test_run_seconds_fit_a_full_check(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_additions_are_found_without_editing_a_file(bench, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    pkg = root / "portbench"
    conf = json.loads((pkg / "configs" / "hspose-real275-fp32.json").read_text())
    conf["name"] = "hspose-real275-fp32-n2056"
    conf["data"] = {"num_points": 2056}
    conf["eval"] = {"recon": True}
    conf["reduced"] = ["num_points"]
    (pkg / "configs" / "hspose-real275-fp32-n2056.json").write_text(json.dumps(conf))
    traffic = json.loads((pkg / "traffic" / "serve-b96-closed.json").read_text())
    traffic.update(kind="online", batch=24, crops_per_request=24, records=[3, 5, 8, 8],
                   rate_per_s=20)
    (pkg / "traffic" / "online-b24.json").write_text(json.dumps(traffic))
    (pkg / "kinds" / "online.py").write_text(ONLINE_KIND)
    for cell in ("online-fp32-n2056", "online-fp32-n2056-x4"):
        (pkg / "limits" / f"{cell}.json").write_text(json.dumps({"limits": {"pose_gap_max": 1.0}}))
    (pkg / "metrics" / "requests.serve.py").write_text(
        "def read(r):\n    return float(r.window['units']) if r.kind == 'serve' else None\n")
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": conf["name"], "source": "https://arxiv.org/abs/2303.15743",
                             "file": "portbench/configs/hspose-real275-fp32-n2056.json",
                             "reduced": ["num_points"], "why": "large clouds"})
    bench["workloads"].append({"name": "online-fp32-n2056", "config": conf["name"],
                               "traffic": "online-b24", "chips": 1, "why": "an open loop"})
    bench["workloads"].append({"name": "online-fp32-n2056-x4", "config": conf["name"],
                               "traffic": "online-b24", "chips": 4, "why": "four replicas"})
    bench["per_layer"].append({"name": "requests.serve", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "harness (evaluation/evaluate.py)",
                               "moves": "crops_per_s", "workloads": ["online-fp32-n2056"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("crops_per_s", "request_ms_p95"):
            m["workloads"].append("online-fp32-n2056")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert manifest.problems(bench, root) == []
    cell, work = manifest.find_cell(bench, "online-fp32-n2056", root)
    assert cell.traffic["rate_per_s"] == 20 and cell.points == 2056
    assert cell.traffic["num_points"] == 2056 and cell.limits == {"pose_gap_max": 1.0}
    names = [m["name"] for m in manifest.metrics_of(bench, "per_layer", "online-fp32-n2056")]
    assert names == ["requests.serve"]
    assert reader("requests.serve", pkg / "metrics")(_Serving()) == 3.0
    probe = subprocess.run([sys.executable, "-c", PROBE.format(root=str(root),
                                                               repo=str(manifest.ROOT))],
                           capture_output=True, text=True, cwd=root)
    assert probe.returncode == 0, probe.stderr
    lines = probe.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == [1, 2056, 24, True]
    assert lines[-1] == "3" and "asks for 4 chips" in probe.stderr
    for path, data in before.items():
        assert path.read_bytes() == data, path


# a traffic kind added as a file: what the harness hands it from the files
ONLINE_KIND = """
CHIPS = 1


def run(cell, seed, seconds, trace, device, t_process):
    from portbench.common import port_config

    cfg = port_config(cell, eval={"eval_batch": cell.traffic["batch"]})
    return [CHIPS, cfg.data.num_points, cfg.eval.eval_batch, cfg.eval.recon]
"""

# in the copy: the new kind found by name and run, and a cell on more chips
# than its kind drives refused before any card is looked for
PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {repo!r}]
from portbench import kinds, manifest
bench = manifest.load()
cell, _ = manifest.find_cell(bench, "online-fp32-n2056")
print(json.dumps(kinds.load(cell.traffic["kind"]).run(cell, 1, 1.0, False, "cpu", 0.0)))
import importlib.util
spec = importlib.util.spec_from_file_location("pb_run", {root!r} + "/portbench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
print(run.main(["--workload", "online-fp32-n2056-x4", "--seed", "1", "--seconds", "1"]))
"""


class _Serving:
    kind = "serve"
    window = {"units": 3}


def test_every_metric_has_a_reader(bench):
    for s in ("end_to_end", "per_layer"):
        for m in bench[s]:
            assert callable(reader(m["name"]))
