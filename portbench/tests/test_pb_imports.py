"""The harness, every configuration, mix, model family and metric reader,
and the reference load with jax and the JAX package blocked, and no loaded
module has the top-level name jax, jaxlib, flax or insmos_tpu (compared
whole: insmos_tpu_torch is the program and allowed). The reference modules
alone load nothing of the program either."""

import os
import subprocess
import sys

from portbench.tests.pb_common import ROOT

_BLOCK = r"""
import sys
for name in ("jax", "jaxlib", "flax", "insmos_tpu"):
    sys.modules[name] = None  # an import of it now raises ImportError
"""

_ALL = _BLOCK + r"""
import glob, importlib, json, os
import portbench.run, portbench.calibrate, portbench.trace, portbench.work
import portbench.reference.model
from portbench.run import load_family, load_metric
bench = json.load(open("BENCHMARK.json"))
families = glob.glob(os.path.join("portbench", "families", "*.py"))
assert families
for f in families:
    load_family(os.path.splitext(os.path.basename(f))[0])
for m in bench["per_layer"]:
    load_metric(m["name"])
for c in bench["configs"]:
    json.load(open(c["file"]))
for w in bench["workloads"]:
    json.load(open(os.path.join("portbench", "mixes", w["traffic"] + ".json")))
import insmos_tpu_torch.pipeline, insmos_tpu_torch.nn.model
tops = {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
print(sorted(tops & {"jax", "jaxlib", "flax", "insmos_tpu"}))
"""

_REF = _BLOCK + r"""
import glob, importlib, os
names = [os.path.basename(f)[:-3] for f in
         glob.glob(os.path.join("portbench", "reference", "*.py"))]
assert "model" in names
for n in names:
    if not n.startswith("_"):
        importlib.import_module("portbench.reference." + n)
import portbench.weights, portbench.traffic
import portbench.check, portbench.stats, portbench.work
tops = {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
print(sorted(tops & {"jax", "jaxlib", "flax", "insmos_tpu", "insmos_tpu_torch"}))
"""


def _run(script):
    return subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_harness_loads_no_jax():
    r = _run(_ALL)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_program():
    r = _run(_REF)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
