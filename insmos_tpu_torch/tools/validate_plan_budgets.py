"""Replay of the span plans' coverage budgets over the fixture streams.

    python -m insmos_tpu_torch.tools.validate_plan_budgets [--device cpu]
        [--scans 12] [--out PATH]

Streams both fixture streams of the JAX package's bench (seed 0, the full
default Config): the ref-exact one (``data/hdl64.make_stream``) and the
fixed-frame one through the incremental mode
(``make_fixed_frame_stream``, ``runtime.incremental_stem``), warm-up
windows included, through ``InferencePipeline.push_scan`` with every span
conv replaced by zeros of its output's shape. A plan is built from site
sets alone, never from features, so every plan and its ``n_overflow`` (rows
whose taps its budgets failed to cover) is the real run's. Prints, per
stream, each step's non-zero counters by plan name and the full per-plan
vector; ``--out`` writes them as JSON. Runs on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

import numpy as np
import torch

from ..config import Config
from ..data.hdl64 import make_fixed_frame_stream, make_stream
from ..pipeline import InferencePipeline
from ..sparse import span_conv as SC
from ..utils.params import init_params, make_model

# the order of the step's span_overflow vector: MotionNet's plans (the
# decoder's L1 plan takes the L1 block plan's place), then UNet's
_MOTION = ["block L2", "block L4", "block L8", "down L2", "down L4",
           "down L8", "dec L2", "dec L4"]
_UNET = [f"unet block L{s}" for s in (1, 2, 4, 8)] + [
    f"unet down L{s}" for s in (2, 4, 8)] + ["unet conv_out"]
PLAN_NAMES = {
    # ref-exact: the T=W stem plan over the window slab first
    "ref_exact": ["stem", "dec L1"] + _MOTION + _UNET,
    # incremental step: the T=1 stem plan over the new scan's slab first
    "fixed_frame": ["stem_scan", "dec L1"] + _MOTION + _UNET,
}


@contextlib.contextmanager
def zero_span_convs():
    """Within the block every span conv returns zeros of its output's
    shape and launches nothing."""
    orig = SC.span_conv_parts

    def zeros(x_keys, feats_cat, weights, parts, out_coords, out_valid, plan,
              T_out):
        width = max(pt.out_off + T_out * pt.cout for pt in parts)
        return torch.zeros((out_coords.shape[0], width), dtype=torch.float32,
                           device=feats_cat.device)

    SC.span_conv_parts = zeros
    try:
        yield
    finally:
        SC.span_conv_parts = orig


def replay(cfg, name: str, n_scans: int, device, seed: int = 0):
    """Per step of the named stream: the span_overflow vector (list of
    ints), in the order of ``PLAN_NAMES[name]``."""
    if name == "fixed_frame":
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, incremental_stem=True))
        scans, tfs, _ = make_fixed_frame_stream(cfg, n_scans, seed)
    else:
        scans, tfs = make_stream(cfg, n_scans, seed)
    params, state = init_params(cfg, np.random.default_rng(0))
    pipe = InferencePipeline(cfg, make_model(cfg, params, state, device),
                             device)
    rows = []
    with zero_span_convs():
        for s, tf in zip(scans, tfs):
            out = pipe.push_scan(s, tf)
            rows.append([int(v) for v in out["overflow"]["span_overflow"]])
    if pipe.n_full_steps:
        raise AssertionError(f"{name}: {pipe.n_full_steps} recovery steps")
    return rows


def nonzero(name: str, rows) -> dict[int, dict[str, int]]:
    """{step: {plan name: rows left uncovered}} over the non-zero counters."""
    names = PLAN_NAMES[name]
    if any(len(r) != len(names) for r in rows):
        raise AssertionError(f"{name}: {len(rows[0])} plans, expected "
                             f"{len(names)}")
    return {t: {names[i]: v for i, v in enumerate(r) if v}
            for t, r in enumerate(rows) if any(r)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--out", help="write the per-step vectors as JSON here")
    args = ap.parse_args(argv)
    cfg = Config()
    result = {}
    for name in PLAN_NAMES:
        rows = replay(cfg, name, args.scans, args.device)
        result[name] = dict(per_step=rows, nonzero=nonzero(name, rows))
        print(f"{name}: plans {PLAN_NAMES[name]}; non-zero n_overflow by "
              f"step {result[name]['nonzero'] or 'none'}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main()
