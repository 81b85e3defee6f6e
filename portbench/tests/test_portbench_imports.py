"""What the benchmark loads: nothing of JAX or of the JAX package, and in the
reference nothing of the port.  Top-level names are compared whole: the
port's name begins with the JAX package's."""

import json
import subprocess
import sys

from portbench.manifest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(imports: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_its_modules_load_no_jax():
    names = _top_level("import importlib.util\n"
                       "spec = importlib.util.spec_from_file_location('pb_run', 'portbench/run.py')\n"
                       "run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)\n"
                       "import portbench.kinds.serve, portbench.kinds.train, portbench.manifest\n"
                       "import portbench.tools.calibrate\n"
                       "import hspose_tpu_torch.evaluation.evaluate, hspose_tpu_torch.engine.train_step\n"
                       "from portbench.readings import reader\n"
                       "from portbench import manifest\n"
                       "[reader(m['name']) for s in ('end_to_end', 'per_layer') "
                       "for m in manifest.load()[s]]")
    assert "portbench" in names and "hspose_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "hspose_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = _top_level("import portbench.reference.model, portbench.reference.precision, "
                       "portbench.reference.geometry_losses")
    assert "portbench" in names
    assert not names & {"hspose_tpu_torch", "hspose_tpu", "jax", "jaxlib", "flax"}
