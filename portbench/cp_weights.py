"""The benchmark's CenterPoint weights: a seeded recipe at weight seed 0,
then BatchNorm statistics calibrated on one window of the ``nus32`` mix,
regression heads scaled to the spreads a trained head gives, and a
calibrated heatmap head, so that the detector works in a deployment's
regime (hundreds of candidates over the score gate, a hundred or so kept
boxes a step, NMS suppressing a real share, box sizes of metres) and not
on a flat heatmap with sizes ``exp`` of random numbers.

The layout is OpenPCDet's, in the port's names: sparse weights (K, cin,
cout) with K x fastest over the kernel, the backbone's block convs with
their biases (``<block>.conv1.b``), dense weights (cout, cin, kh, kw),
the transposed convs (cin, cout, kh, kw).

Every BN of the dense half (the BEV backbone, the shared conv, the heads)
has its shift raised by ``DENSE_BN_SHIFT``. With shifts near 0 a stack
of random conv-BN-ReLU layers amplifies rounding: the next BN divides by
the spread of a ReLU's output over the map, which leaves out the
output's mean, while a rounding error passes wherever the unit is on, so
each such conv multiplies the relative error of its input by about 1.2.
Over the BEV backbone's 14 convs and the head's 2, bf16 then moved every
head map by 6-9% of its spread, and the kept boxes' sizes and
velocities by tens of percent. With most units on (shift +1) the factor
is about 1.06, and the head maps move by under 1% (the reference in
bf16 against itself in float32, at the tests' small size). The sparse
backbone's residual blocks keep its error small without a shift (0.7% at
its output).

The published heatmap bias of -2.19 gives a flat map a score of 0.1007,
right on the 0.1 gate, where every cell is a near-tie; so, as the
InsMOS recipe does (``portbench/weights.py``), the heatmap bias is
-log(99) and its weights are scaled (``HM_SCALE``).

``--seed`` moves the traffic, never the weights: the statistics are
calibrated for these weights alone. To write them anew (on the card):

    python3 -m portbench.cp_weights --calibrate

which runs the float32 reference (``portbench/reference/centerpoint.py``)
on the window of ``CAL_SEED``'s drive that ends at step ``CAL_STEP``,
every BN normalising by its input's own statistics, and writes each BN's
mean and (biased) variance to ``cp_calibrated_state.npz``; then, BN
frozen, each regression output's gain (``REG``'s spread over its
standard deviation on that window). ``--sweep 0.5,1`` (with or without
``--calibrate``) prints the candidates and kept boxes on the windows of
``CHECK_SEEDS`` x ``CHECK_STEPS`` at each heatmap scale, on the file at
``--out``. ``HM_SCALE`` 1.0 keeps 95-184 boxes a step there (148 at the
median) of 117-365 candidates.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from portbench.weights import _bn, _uniform

CALIBRATED_STATE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "cp_calibrated_state.npz")
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                      "centerpoint-voxel0075-nus.json")
DENSE_BN_SHIFT = 1.0
HM_BIAS = float(-np.log(99.0))
HM_SCALE = 1.0
# (bias, spread) of each regression head's outputs over the map, as a
# trained head gives them: an offset within the cell, a centre about 0.9 m
# under the sensor, log sizes near the group's mean box, a unit rotation
# vector's two parts, velocities of a few m/s. The dim bias is per group
# (SIZES); the spread is each output's standard deviation on the
# calibration window.
REG = {"center": (0.5, 0.25), "center_z": (-0.9, 0.3), "dim": (None, 0.15),
       "rot": (0.0, 1.0), "vel": (0.0, 2.0)}
# about nuScenes' mean (l, w, h) in metres of each group's first class
SIZES = {"car": (4.63, 1.97, 1.74), "truck": (6.93, 2.51, 2.84),
         "bus": (10.5, 2.94, 3.47), "barrier": (0.50, 2.53, 0.98),
         "motorcycle": (2.11, 0.77, 1.47), "pedestrian": (0.73, 0.67, 1.77)}
CAL_SEED, CAL_STEP = 7, 40
CHECK_SEEDS = (7, 11, 977, 2**31 + 3)
CHECK_STEPS = (60, 140, 220)
_F32 = np.float32


def _sparse(rng, K, cin, cout, name, out, bias=False):
    b = 1.0 / np.sqrt(K * cin)
    out[f"{name}.w"] = _uniform(rng, (K, cin, cout), b)
    if bias:
        out[f"{name}.b"] = _uniform(rng, (cout,), b)


def _dense(rng, cin, cout, name, out):
    b = 1.0 / np.sqrt(9 * cin)
    out[f"{name}.w"] = _uniform(rng, (cout, cin, 3, 3), b)
    out[f"{name}.b"] = _uniform(rng, (cout,), b)


def init_state(cd: dict) -> dict[str, np.ndarray]:
    """The recipe's tensors by state-dict name (numpy float32); ``cd`` is
    the configuration file's ``config`` object."""
    rng = np.random.default_rng(0)
    m = cd["model"]
    out: dict[str, np.ndarray] = {}
    ch = m["backbone"]["channels"]
    p = "backbone3d"
    _sparse(rng, 27, m["point_features"], ch[0], f"{p}.conv_input.conv", out)
    _bn(rng, ch[0], f"{p}.conv_input.bn", out)
    for lvl in range(1, 5):
        c = ch[lvl - 1]
        if lvl > 1:
            _sparse(rng, 27, ch[lvl - 2], c, f"{p}.conv{lvl}_down.conv", out)
            _bn(rng, c, f"{p}.conv{lvl}_down.bn", out)
        for blk in range(2):
            q = f"{p}.conv{lvl}.{blk}"
            _sparse(rng, 27, c, c, f"{q}.conv1", out, bias=True)
            _bn(rng, c, f"{q}.bn1", out)
            _sparse(rng, 27, c, c, f"{q}.conv2", out, bias=True)
            _bn(rng, c, f"{q}.bn2", out)
    _sparse(rng, 3, ch[3], ch[3], f"{p}.conv_out.conv", out)
    _bn(rng, ch[3], f"{p}.conv_out.bn", out)

    b = m["bev"]
    for lvl in range(len(b["layer_nums"])):
        c_in = b["num_bev_features"] if lvl == 0 else b["num_filters"][lvl - 1]
        nf = b["num_filters"][lvl]
        for k in range(b["layer_nums"][lvl] + 1):
            src = c_in if k == 0 else nf
            out[f"bev.blocks.{lvl}.convs.{k}.w"] = _uniform(
                rng, (nf, src, 3, 3), 1.0 / np.sqrt(9 * src))
            _bn(rng, nf, f"bev.blocks.{lvl}.bns.{k}", out)
        s, nu = b["upsample_strides"][lvl], b["num_upsample_filters"][lvl]
        out[f"bev.deblocks.{lvl}.conv.w"] = _uniform(
            rng, (nf, nu, s, s), 1.0 / np.sqrt(s * s * nf))
        _bn(rng, nu, f"bev.deblocks.{lvl}.bn", out)

    h = m["head"]
    c = h["head_channels"]
    _dense(rng, sum(b["num_upsample_filters"]), h["shared_channels"],
           "head.shared.conv", out)
    _bn(rng, h["shared_channels"], "head.shared.bn", out)
    for g, classes in enumerate(h["groups"]):
        for name, n in list(h["heads"]) + [("hm", len(classes))]:
            q = f"head.groups.{g}.{name}"
            _dense(rng, c, c, f"{q}.conv1", out)
            _bn(rng, c, f"{q}.bn", out)
            _dense(rng, c, n, f"{q}.conv2", out)
            if name == "hm":
                out[f"{q}.conv2.b"][:] = -2.19  # the published init
    for k in out:
        if k.startswith(("bev.", "head.")) and k.endswith(".bias"):
            out[k] += np.float32(DENSE_BN_SHIFT)
    return out


def hm_names(cd: dict) -> list[str]:
    return [f"head.groups.{g}.hm.conv2"
            for g in range(len(cd["model"]["head"]["groups"]))]


def reg_heads(cd: dict):
    """(group, head, state-dict prefix of its last conv, its output bias)
    of every regression head."""
    h = cd["model"]["head"]
    for g, classes in enumerate(h["groups"]):
        for name, n in h["heads"]:
            bias, _ = REG[name]
            if name == "dim":
                bias = np.log(np.asarray(SIZES[classes[0]]))
            yield (g, name, f"head.groups.{g}.{name}.conv2",
                   np.full(n, bias, _F32))


def state_dict(cd: dict, device="cpu", calibrated: bool = True,
               hm_scale: float | None = None,
               stats_file: str = CALIBRATED_STATE) -> dict[str, torch.Tensor]:
    """The benchmark's weights as a state dict on ``device`` (reference
    layout: the block conv biases explicit): the recipe, then with
    ``calibrated`` the frozen BN statistics, each regression head's last
    conv scaled by output to its spread (the file's ``<conv>.gain``) with
    the bias of ``REG``, and the heatmap head (bias -log(99), weights x
    ``hm_scale``, by default ``HM_SCALE``)."""
    sd = init_state(cd)
    if calibrated:
        with np.load(stats_file) as z:
            for k in z.files:
                if k.endswith(".gain"):
                    continue
                if k not in sd or sd[k].shape != z[k].shape:
                    raise KeyError(f"calibrated statistic {k} has no weight")
                sd[k] = z[k].astype(_F32)
            for _, _, q, bias in reg_heads(cd):
                if f"{q}.gain" in z.files:
                    gain = z[f"{q}.gain"].astype(_F32)
                    sd[f"{q}.w"] = sd[f"{q}.w"] * gain[:, None, None, None]
                    sd[f"{q}.b"] = bias
        s = HM_SCALE if hm_scale is None else hm_scale
        for q in hm_names(cd):
            sd[f"{q}.w"] = sd[f"{q}.w"] * np.float32(s)
            sd[f"{q}.b"] = np.full_like(sd[f"{q}.b"], HM_BIAS)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in sd.items()}


# ---------------------------------------------------------------- calibrate
def _windows(cd, mix, seed, ends):
    """{end: (sweeps, transforms)} of the W steps ending at each of
    ``ends`` in the drive of ``seed``."""
    from portbench import traffic

    W = cd["sweeps"]["n_sweeps"]
    st = traffic.Stream(seed, mix, cd["runtime"]["max_points_per_scan"],
                        False, cd["data"]["voxel_size"][0], max(ends) + 1)
    items = [st.next() for _ in range(max(ends) + 1)]
    return {e: ([s for s, _ in items[e - W + 1:e + 1]],
                [t for _, t in items[e - W + 1:e + 1]]) for e in ends}


def calibrate(device: str, out: str = CALIBRATED_STATE):
    import json

    from portbench.reference import centerpoint as ref
    from portbench.run import load_mix

    with open(CONFIG) as fh:
        cd = json.load(fh)["config"]
    mix = load_mix("nus32")
    sd = state_dict(cd, device, calibrated=False)
    scans, tfs = _windows(cd, mix, CAL_SEED, (CAL_STEP,))[CAL_STEP]
    stats = {}
    ref.step(cd, sd, scans, tfs, device=device, calib=stats)
    arrays = {}
    for name, (mean, var) in stats.items():
        arrays[f"{name}.mean"] = mean.cpu().numpy().astype(_F32)
        arrays[f"{name}.var"] = var.cpu().numpy().astype(_F32)
    np.savez(out, **arrays)
    # the regression heads' spread on the same window, BN now frozen
    sd = state_dict(cd, device, stats_file=out)
    maps = ref.step(cd, sd, scans, tfs, device=device,
                    with_maps=True)["maps"]
    for g, name, q, _ in reg_heads(cd):
        m = maps[g][name] - sd[f"{q}.b"].cpu().numpy()[:, None, None]
        arrays[f"{q}.gain"] = (REG[name][1] / m.reshape(len(m), -1).std(
            axis=1)).astype(_F32)
    np.savez(out, **arrays)
    print(f"wrote {len(stats)} BN statistics and the regression gains to "
          f"{out}")


def sweep(device: str, scales, stats_file: str = CALIBRATED_STATE, cd=None,
          wins=None):
    """Prints the candidates and kept boxes of the float32 reference on
    the windows ending at ``CHECK_STEPS`` of each of ``CHECK_SEEDS``'
    drives, at each heatmap scale."""
    import json

    from portbench.reference import centerpoint as ref
    from portbench.run import load_mix

    if cd is None:
        with open(CONFIG) as fh:
            cd = json.load(fh)["config"]
    if wins is None:
        mix = load_mix("nus32")
        wins = {(seed, e): w for seed in CHECK_SEEDS
                for e, w in _windows(cd, mix, seed, CHECK_STEPS).items()}
    for s in scales:
        sd = state_dict(cd, device, hm_scale=s, stats_file=stats_file)
        for (seed, step), (scans, tfs) in wins.items():
            r = ref.step(cd, sd, scans, tfs, device=device)
            b = r["boxes"]
            size = np.median(b[:, 3:6], axis=0) if len(b) else np.zeros(3)
            speed = np.median(np.hypot(b[:, 7], b[:, 8])) if len(b) else 0.0
            print(f"hm_scale {s}: seed {seed} step {step} candidates "
                  f"{r['counts']['candidates']} kept {len(r['scores'])} "
                  f"voxels {r['counts']['voxels']} size p50 "
                  f"{size.round(2).tolist()} |v| p50 {speed:.2f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=CALIBRATED_STATE)
    ap.add_argument("--sweep", help="heatmap scales, comma-separated")
    args = ap.parse_args(argv)
    if args.calibrate:
        calibrate(args.device, args.out)
    if args.sweep:
        sweep(args.device, [float(x) for x in args.sweep.split(",")],
              args.out)


if __name__ == "__main__":
    main()
