"""The readings the check's limits are set from, for one cell.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3
        [--seconds 5] [--control] [--out PATH]
    python3 -m portbench.calibrate --config <config> --mix <mix> ...

(the second form for a pair that is not a cell of BENCHMARK.json).

For each seed, in one process, one run of the cell as ``run.py`` makes it
(:func:`portbench.run.run`), with a window of ``--seconds``: the check's
numbers on the steps it compares are the lower readings. With
``--control``, the same steps through the configuration's family's plain
reference in the family's ``CONTROL_DTYPE`` (InsMOS: matmul operands in
float8 e4m3, the precision below the configuration's bfloat16), held
against the float32 reference (the upper readings). Prints
one JSON line per seed; ``--out`` also writes them all. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.run import (ROOT as BENCH_ROOT, cell_files,  # noqa: E402
                           family_name, load_family, load_json, load_mix,
                           pin_cores, run)


def readings(cfg_doc, mix, seed, seconds, control, device="cuda",
             child_cpu=None):
    """One run's readings: the program's numbers and, with ``control``,
    the control's, beside the run's counts."""
    dtype = load_family(family_name(cfg_doc)).CONTROL_DTYPE
    result, _ = run(cfg_doc, mix, seed, seconds, False, [], device,
                    child_cpu=child_cpu, control=dtype if control else None)
    out = dict(seed=seed, correct=result["correct"],
               attempted=result["attempted"], failed=result["failed"],
               inexact=result["inexact"],
               compared=result["compared"]["steps"],
               streams=result["compared"]["streams"],
               failed_by=result["compared"]["failed_by"],
               feed_share=result["window"]["feed_share"],
               program=result["compared"]["numbers"])
    if control:
        out["control"] = result["control"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--config", help="with --mix, instead of --workload")
    ap.add_argument("--mix")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.workload:
        _, cfg_doc, mix, _ = cell_files(BENCH_ROOT, args.workload)
        name = args.workload
    else:
        cfg_doc = load_json(os.path.join(HERE, "configs",
                                         args.config + ".json"))
        mix = load_mix(args.mix)
        name = f"{args.config}x{args.mix}"
    child_cpu = pin_cores()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA device")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cfg_doc, mix, seed, args.seconds, args.control,
                       child_cpu=child_cpu)
        row["workload"] = name
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
