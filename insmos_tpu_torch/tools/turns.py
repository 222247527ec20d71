"""Probe kernels of two copies of the port in turns on one card: an earlier
copy (OLD, the root of a checkout that holds ``insmos_tpu_torch/``, e.g.
``runs/old`` from ``git archive``) against this one, in the order old, new,
new, old, each in a process of its own.

    python -m insmos_tpu_torch.tools.turns dot|gather|extract|rowconv OLD \
        [--out PATH]

``dot``: the T12 kernels (``dot_turns.py``); ``gather``: the micro-gather
kernels of T1, T3-T5 and T7-T9 (``gather_turns.py``); ``extract``: the T10
kernels (``extract_turns.py``); ``rowconv``: the T11 kernel
(``rowconv_turns.py``). Each process puts its
tree first on ``sys.path``, loads this tree's timing helpers
(``tools/__init__.py``) and the worker script by path, and runs the
script's ``worker(timing)``, which imports the tree's own kernels, holds
their outputs against their plain versions and returns one reading per case
(``label``, events ``ms``, ``device_ms``, and ``library_device_ms`` where
one PyTorch call computes the same function). Prints the readings side by
side; ``--out`` writes them all as JSON. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
NEW = HERE.parents[1]
ORDER = ("old", "new", "new", "old")
WORKERS = {name: HERE / f"{name}_turns.py"
           for name in ("dot", "gather", "extract", "rowconv")}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(script: str, tree: str, out: str):
    """Run ``script``'s worker on ``tree``'s kernels; write the readings to
    ``out``."""
    sys.path[:] = [tree] + [p for p in sys.path if Path(p or ".").resolve()
                            != HERE]
    timing = _load("turns_timing", HERE / "__init__.py")
    rows = _load("turns_worker", Path(script)).worker(timing)
    with open(out, "w") as fh:
        json.dump(dict(tree=tree, card=timing.card_line(), rows=rows), fh)


def table(runs: list[dict]) -> list[str]:
    """One line per label (in order of first reading): each run's events
    ms, device ms and, where read, the one-call's device ms; '-' where a
    run has no such reading."""
    labels = list(dict.fromkeys(r["label"] for run in runs
                                for r in run["rows"]))
    by_run = [{r["label"]: r for r in run["rows"]} for run in runs]
    order = ", ".join(run["which"] for run in runs)
    lines = [f"label | events ms {order} | device ms {order} | one-call "
             f"device ms {order}"]
    for lab in labels:
        cols = []
        for key in ("ms", "device_ms", "library_device_ms"):
            vals = [b.get(lab, {}).get(key) for b in by_run]
            cols.append(", ".join("-" if v is None else f"{v:.4f}"
                                  for v in vals))
        lines.append(f"{lab} | " + " | ".join(cols))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=sorted(WORKERS))
    ap.add_argument("old")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    trees = {"old": str(Path(args.old).resolve()), "new": str(NEW)}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, which in enumerate(ORDER):
            path = os.path.join(tmp, f"{i}.json")
            env = dict(os.environ, PYTHONPATH=trees[which])
            subprocess.run([sys.executable, __file__, "--worker",
                            str(WORKERS[args.probe]), trees[which], path],
                           check=True, env=env, cwd=trees[which])
            with open(path) as fh:
                runs.append(dict(which=which, **json.load(fh)))
    print(runs[0]["card"])
    print("\n".join(table(runs)))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(runs, fh, indent=1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:  # one process of main's turns
        worker(*sys.argv[2:])
    else:
        main()
