"""The T12 probe kernels (csrc/probe_dot.cu) of two copies of the port in
turns on one card: an earlier copy (OLD, the root of a checkout that holds
``insmos_tpu_torch/``, e.g. ``runs/old``) against this one, in the order
old, new, new, old, each in a process of its own.

    python insmos_tpu_torch/tools/dot_turns.py OLD [--out PATH]

Each process runs ``probe_dotshapes.SHAPES`` through its own tree's
``dot_cuda``, both variants, at one copy and at one copy per SM: holds the
output against ``dot_plain`` (1e-4 x max(1, max|plain|)), then reads the
CUDA-event ms and the device ms (torch.profiler) per call with this tree's
``tools.cuda_ms`` and ``tools.device_ms``. Prints a table of the readings
side by side; ``--out`` writes them all as JSON. Needs one CUDA device.
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
ITERS = 10


def worker(tree: str, out: str):
    """Time one tree's kernels; write the readings to ``out``."""
    sys.path[:] = [tree] + [p for p in sys.path if Path(p or ".").resolve()
                            != HERE]
    import torch

    from insmos_tpu_torch import setup_device
    from insmos_tpu_torch.tools import probe_dotshapes as PD

    spec = importlib.util.spec_from_file_location("dot_timing",
                                                  HERE / "__init__.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    dev = setup_device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, M, K, N, n_dots in PD.SHAPES:
        reps = PD.REP * n_dots
        a, b = (torch.from_numpy(x).to(dev, torch.bfloat16)
                for x in PD.make_operands(M, K, N))
        ref = PD.dot_plain(a, b, reps)
        for v in PD.VARIANTS:
            for c in (1, sms):
                err, scale = timing.max_err(PD.dot_cuda(a, b, reps, v, c),
                                            ref)
                if err > 1e-4 * scale:
                    raise AssertionError(f"{tree} {name} {v} copies={c}: "
                                         f"err {err:.3g}")
                fn = lambda: PD.dot_cuda(a, b, reps, v, c)  # noqa: E731
                rows.append(dict(shape=name, variant=v, copies=c, err=err,
                                 ms=timing.cuda_ms(fn, ITERS),
                                 device_ms=timing.device_ms(fn, ITERS)))
    with open(out, "w") as fh:
        json.dump(dict(tree=tree, card=timing.card_line(), rows=rows), fh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", nargs="?")
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.json)
    trees = {"old": str(Path(args.old).resolve()), "new": str(NEW)}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, which in enumerate(("old", "new", "new", "old")):
            path = os.path.join(tmp, f"{i}.json")
            env = dict(os.environ, PYTHONPATH=trees[which])
            subprocess.run([sys.executable, __file__, "--worker",
                            trees[which], "--json", path], check=True, env=env,
                           cwd=trees[which])
            with open(path) as fh:
                runs.append(dict(which=which, **json.load(fh)))
    print(runs[0]["card"])
    print("shape | variant | copies | events ms old, new, new, old | "
          "device ms old, new, new, old")
    for i, row in enumerate(runs[0]["rows"]):
        rs = [r["rows"][i] for r in runs]
        print(f"{row['shape']} | {row['variant']} | {row['copies']} | "
              + ", ".join(f"{r['ms']:.4f}" for r in rs) + " | "
              + ", ".join(f"{r['device_ms']:.4f}" for r in rs))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(runs, fh, indent=1)


if __name__ == "__main__":
    main()
