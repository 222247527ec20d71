"""The port's inference CLIs and the modules they stand on, against the JAX
package: constants, the config loaders (both YAML schemas), the KITTI file
helpers, the scan prefetcher, the synthetic sequence writer, the artifact
writer, the checkpoint converter, checkpoints, and predict_mos (with and
without --fixed-frame), refine, evaluate_mos and the visualizer's box and
colour logic on what predict_mos wrote.

predict_mos runs on a tiny synthetic sequence, float32, from the same numpy
weights on both sides (an orbax checkpoint for the JAX CLI, a port
checkpoint for the port's, ``--device cpu``). The point logits behind the
written files agree within CPU_LOGIT_ABS, and at most CPU_MOVED_SHARE of a
scan's points differ by more than LOGIT_TOL; the ``.label`` files are equal
at every point whose two largest JAX logits differ by more than twice
CPU_LOGIT_ABS; the confidences agree within what the logits allow; the
bbox dicts have the same keys and dtypes and the kept boxes agree as sets
within LOGIT_TOL, but for at most CPU_BOX_UNMATCHED of each side. The
random weights' detection scores are nearly flat, so NMS may keep a few
other boxes on either side, and the instance fusion then moves the logits
of nearby points; elsewhere the two packages agree to ~1e-7, hence
LOGIT_TOL 1e-5."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

from insmos_tpu import config as jax_config
from insmos_tpu import constants as jax_constants
from insmos_tpu.cli import evaluate_mos as jax_evaluate
from insmos_tpu.cli import predict_mos as jax_predict
from insmos_tpu.cli import refine as jax_refine
from insmos_tpu.cli import visualize as jax_visualize
from insmos_tpu.data import kitti as jax_kitti
from insmos_tpu.data import loader as jax_loader
from insmos_tpu.data import synthetic as jax_synthetic
from insmos_tpu.utils import checkpoint as jax_checkpoint
from insmos_tpu.utils import convert as jax_convert
from insmos_tpu.utils import io as jax_io
from insmos_tpu_torch import config as port_config
from insmos_tpu_torch import obs
from insmos_tpu_torch import constants as port_constants
from insmos_tpu_torch.cli import evaluate_mos, predict_mos, refine, visualize
from insmos_tpu_torch.data import kitti, loader, synthetic
from insmos_tpu_torch.tools import stream_record as SR
from insmos_tpu_torch.utils import convert, io
from insmos_tpu_torch.utils.checkpoint import (load_checkpoint,
                                               save_checkpoint,
                                               save_checkpoint_from_trees)
from insmos_tpu_torch.utils.params import init_params, load_jax_params

from sd_builder import make_synthetic_state_dict
from test_torch_model import port_config as to_port_config
from torch_port_common import tiny_config

LOGIT_TOL = 1e-5
# Bounds of the CPU comparison, from its readings in both modes: the logits
# of every point agree within 3e-8 but at one step, where NMS kept another
# set and 2 of the scan's 1280 points moved by 0.0087; the kept boxes, 3
# unmatched over the 6 steps, at most 2 of a step's 113. Every label whose
# JAX top two differ at all has them more than 0.04 apart at this size.
CPU_LOGIT_ABS = 0.02
CPU_MOVED_SHARE = 0.005
CPU_BOX_UNMATCHED = 0.05
N_SCANS = 6
MODES = {"default": [], "fixed_frame": ["--fixed-frame"]}


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}.{i}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A synthetic sequence (seq 08) shrunk to the tiny config's 12.8 m
    grid, as tests/test_closed_loop.py shrinks it, with the ego moving 2
    voxels a step; the same numpy weights as a JAX orbax checkpoint and as
    a port checkpoint; and both predict_mos CLIs run over it in both
    modes."""
    base = tmp_path_factory.mktemp("cli")
    root = str(base / "kitti")
    jax_synthetic.write_synthetic_sequence(
        root, seq=8, n_scans=N_SCANS, seed=7, dt=0.2, ego_speed=1.0,
        n_ground=800, n_per_obj=60, n_static=5, n_moving=3, area=(5.0, 5.0),
        mover_area=(3.2, 3.2), mover_speed=1.5, mover_dims=(2.6, 1.4, 1.3),
        ground_extent=(6.0, 6.0))
    cfg = tiny_config(window=3)
    pcfg = to_port_config(cfg)
    params, state = init_params(pcfg, np.random.default_rng(0))
    jckpt, pckpt = str(base / "jax_ckpt"), str(base / "port_ckpt")
    jax_checkpoint.save_checkpoint(jckpt, cfg, params, state, step=3)
    save_checkpoint_from_trees(pckpt, pcfg, params, state, step=3)
    runs = {}
    for mode, flags in MODES.items():
        for side, mod, ckpt, extra in (
                ("jax", jax_predict, jckpt, []),
                ("port", predict_mos, pckpt, ["--device", "cpu"])):
            out = str(base / f"{side}_{mode}")
            argv = ["--ckpt", ckpt, "--data_path", root, "--sequences", "8",
                    "--out", out] + flags + extra
            created = []
            with SR.capturing(mod) as steps:
                capture = mod.InferencePipeline

                class Keep(capture):
                    def __init__(self, *a, **kw):
                        super().__init__(*a, **kw)
                        created.append(self)

                mod.InferencePipeline = Keep
                try:
                    stats = mod.run(mod.parse_args(argv))
                finally:
                    mod.InferencePipeline = capture
            runs[side, mode] = dict(
                out=os.path.join(out, cfg.experiment_id), stats=stats,
                steps=[SR.to_numpy(o) | {"n_raw": n} for o, n in steps],
                n_full_steps=created[0].n_full_steps)
    return dict(root=root, cfg=cfg, pcfg=pcfg, params=params, state=state,
                pckpt=pckpt, runs=runs, base=base)


# ------------------------------------------------------- copied modules
def test_constants_match_jax():
    for name in ("N_MOS_CLASSES", "IGNORE_INDEX", "LEARNING_MAP_TABLE",
                 "LEARNING_MAP_INV", "DET_CLASS_NAMES", "N_DET_CLASSES"):
        _tree_equal(getattr(jax_constants, name),
                    getattr(port_constants, name), name)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    raw[:300] = rng.choice([0, 1, 9, 40, 251, 259], 300)
    _tree_equal(jax_constants.map_semantic_labels(raw),
                port_constants.map_semantic_labels(raw))
    lab = rng.integers(0, 3, 100)
    _tree_equal(jax_constants.to_original_labels(lab),
                port_constants.to_original_labels(lab))
    det = rng.integers(0, 12, 100)
    _tree_equal(jax_constants.merge_det_class(det),
                port_constants.merge_det_class(det))


_REFERENCE_YAML = {
    "EXPERIMENT": {"ID": "ref_exp"},
    "DATA": {"POINT_CLOUD_RANGE": [-40.0, -30.0, -3.0, 40.0, 30.0, 1.0],
             "VOXEL_SIZE": [0.1, 0.1, 0.1], "TRANSFORM": True,
             "POSES": "poses.txt", "SHUFFLE": False, "NUM_WORKER": 2,
             "DELTA_T_DATA": 0.1,
             "SPLIT": {"TRAIN": [0, 1], "VAL": [8], "TEST": [11, 12]}},
    "MODEL": {"DELTA_T_PREDICTION": 0.1, "N_PAST_STEPS": 8,
              "MAP_TO_BEV": {"NUM_BEV_FEATURES": 256},
              "BACKBONE_2D": {"LAYER_NUMS": [5], "NUM_FILTERS": [128]},
              "DENSE_HEAD": {"NUM_CLASS": 3,
                             "TARGET_ASSIGNER_CONFIG": {"MAX_OBJS": 50},
                             "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                                 "cls_weight": 1.0, "loc_weight": 2.0}}},
              "POST_PROCESSING": {"SCORE_THRESH": 0.2,
                                  "NMS_CONFIG": {"NMS_THRESH": 0.05,
                                                 "MULTI_CLASSES_NMS": True}}},
    "TRAIN": {"MAX_EPOCH": 10, "LR": 3e-4, "BATCH_SIZE": 2},
}


@pytest.mark.parametrize("schema", ["flat", "reference", "default"])
def test_config_loaders_match_jax(schema, tmp_path):
    path = str(tmp_path / "cfg.yaml")
    if schema == "flat":
        d = json.loads(json.dumps(jax_config.Config().tiny(points=512)
                                  .to_dict()))
        d["experiment_id"] = "flat_exp"
        d["model"]["n_past_steps"] = 3
        d["runtime"]["compute_dtype"] = "float32"
        with open(path, "w") as fh:
            yaml.safe_dump(d, fh)
    elif schema == "reference":
        with open(path, "w") as fh:
            yaml.safe_dump(_REFERENCE_YAML, fh)
    else:
        path = None
    ref = jax_config.load_config(path)
    got = port_config.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert port_config.Config.from_dict(got.to_dict()) == got
    if path:
        assert port_config.Config.from_yaml(path) == got


def test_kitti_helpers_match_jax(cli_setup, tmp_path):
    seq = os.path.join(cli_setup["root"], "08")
    assert kitti.load_files(seq) == jax_kitti.load_files(seq)
    pose_f, calib_f = (os.path.join(seq, f) for f in ("poses.txt",
                                                      "calib.txt"))
    _tree_equal(jax_kitti.load_poses(pose_f), kitti.load_poses(pose_f))
    _tree_equal(jax_kitti.load_calib(calib_f), kitti.load_calib(calib_f))
    lp = kitti.lidar_poses_from_files(pose_f, calib_f)
    _tree_equal(jax_kitti.lidar_poses_from_files(pose_f, calib_f), lp)
    for f in kitti.load_files(os.path.join(seq, "velodyne"))[:2]:
        _tree_equal(jax_kitti.read_point_cloud(f), kitti.read_point_cloud(f))
    for f in kitti.load_files(os.path.join(seq, "labels"))[:2]:
        _tree_equal(jax_kitti.read_labels(f), kitti.read_labels(f))
    _tree_equal(jax_kitti.read_labels(str(tmp_path / "missing.label")),
                kitti.read_labels(str(tmp_path / "missing.label")))
    boxes = kitti.load_files(os.path.join(seq, "boundingbox_label"))
    empty = str(tmp_path / "empty.npy")
    np.save(empty, np.array([], dtype=object), allow_pickle=True)
    static = str(tmp_path / "static.npy")
    np.save(static, np.array([[0, 8, 0, [1.0, 2, 0, 1, 1, 2, 0.3]]],
                             dtype=object), allow_pickle=True)
    for f in boxes[:2] + [empty, static]:
        _tree_equal(jax_kitti.read_bounding_box_label(f),
                    kitti.read_bounding_box_label(f))
    xyz = kitti.read_point_cloud(kitti.load_files(
        os.path.join(seq, "velodyne"))[0])[:, :3]
    _tree_equal(jax_kitti.transform_point_cloud(xyz, lp[3], lp[1]),
                kitti.transform_point_cloud(xyz, lp[3], lp[1]))


@pytest.mark.parametrize("workers", [0, 3])
def test_prefetch_map_matches_jax(workers):
    items = list(range(23))
    fn = lambda i: np.arange(i)  # noqa: E731
    ref = list(jax_loader.prefetch_map(fn, items, num_workers=workers,
                                       prefetch=4))
    got = list(loader.prefetch_map(fn, items, num_workers=workers,
                                   prefetch=4))
    _tree_equal(ref, got)


def test_synthetic_sequence_bytes_equal(tmp_path):
    kw = dict(seq=3, n_scans=3, seed=5, n_ground=300, n_per_obj=20)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_synthetic.write_synthetic_sequence(a, **kw)
    synthetic.write_synthetic_sequence(b, **kw)
    files = _files(a)
    assert files == _files(b) and len(files) == 3 * 3 + 2
    for f in files:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_write_scan_artifacts_bytes_equal(tmp_path):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(500, 3)).astype(np.float32)
    boxes = rng.normal(size=(7, 7)).astype(np.float32)
    scores = rng.uniform(size=7).astype(np.float32)
    labels = rng.integers(1, 4, 7).astype(np.int32)
    roots = []
    for side, mod in (("jax", jax_io), ("port", io)):
        dirs = mod.artifact_dirs(str(tmp_path / side), "exp", 8)
        mod.write_scan_artifacts(dirs, 4, logits, boxes, scores, labels)
        roots.append(str(tmp_path / side))
    files = _files(roots[0])
    assert files == _files(roots[1]) and len(files) == 3
    for f in files:
        with open(os.path.join(roots[0], f), "rb") as fa, \
                open(os.path.join(roots[1], f), "rb") as fb:
            assert fa.read() == fb.read(), f
    lab = [f for f in files if f.endswith(".label")][0]
    _tree_equal(jax_io.read_pred_labels(os.path.join(roots[0], lab)),
                io.read_pred_labels(os.path.join(roots[1], lab)))
    _tree_equal(jax_io.softmax_ignore(logits), io.softmax_ignore(logits))


def test_convert_checkpoint_matches_jax(tmp_path):
    cfg = to_port_config(tiny_config(window=2))
    params, state = init_params(cfg, np.random.default_rng(0))
    sd = make_synthetic_state_dict(cfg, params, seed=4)
    sd["model.unet.extra_key.weight"] = np.zeros(3, np.float32)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "hyper_parameters": {}}, path)
    ref = jax_convert.convert_checkpoint(path, copy.deepcopy(params),
                                         copy.deepcopy(state))
    got = convert.convert_checkpoint(path, copy.deepcopy(params),
                                     copy.deepcopy(state))
    _tree_equal(ref[0], got[0], "params")
    _tree_equal(ref[1], got[1], "state")
    assert ref[2] == got[2] == ["model.unet.extra_key.weight"]
    # the converted trees load into the port's model
    from insmos_tpu_torch.nn.model import InsMOSModel

    InsMOSModel(cfg).load_state_dict(load_jax_params(got[0], got[1], "cpu"),
                                     strict=True)
    rng = np.random.default_rng(1)
    for fn, shape in (("t_spconv", (4, 3, 3, 3, 5)), ("t_linear", (4, 3)),
                      ("t_conv2d", (4, 3, 3, 3)),
                      ("t_conv2d_transpose", (4, 5, 2, 2)),
                      ("t_me_kernel", (27, 3, 4))):
        x = rng.normal(size=shape).astype(np.float32)
        _tree_equal(getattr(jax_convert, fn)(x), getattr(convert, fn)(x), fn)


def test_checkpoint_roundtrip(cli_setup, tmp_path):
    pcfg, params, state = (cli_setup[k] for k in ("pcfg", "params", "state"))
    cfg, model, step = load_checkpoint(cli_setup["pckpt"], "cpu")
    assert cfg == pcfg and step == 3 and not model.training
    want = load_jax_params(params, state, "cpu")
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # config.json holds what the JAX package writes for the same values
    with open(os.path.join(cli_setup["pckpt"], "config.json")) as fa, open(
            os.path.join(cli_setup["base"], "jax_ckpt", "config.json")) as fb:
        assert fa.read() == fb.read()
    # save_checkpoint from a module, and a config override at load
    path = str(tmp_path / "again")
    save_checkpoint(path, cfg, model, step=9)
    cfg2 = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, compute_dtype="bfloat16"))
    cfg3, model3, step3 = load_checkpoint(path, "cpu", cfg2)
    assert step3 == 9 and cfg3 == cfg2 and model3.cfg == cfg2
    for k, v in model3.state_dict().items():
        assert torch.equal(v, want[k]), k


# -------------------------------------------------------------- the CLIs
def _artifacts(pred_root, i):
    sub = os.path.join("sequences", "08", "predictions")
    lab = np.fromfile(os.path.join(pred_root, "mos_preb", sub,
                                   f"{i:06d}.label"), np.int32)
    conf = np.load(os.path.join(pred_root, "confidence", sub,
                                f"{i:06d}.npy"))
    box = np.load(os.path.join(pred_root, "bbox_preb", sub, f"{i:06d}.npy"),
                  allow_pickle=True).item()
    return lab, conf, box


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_mos_matches_jax(cli_setup, mode):
    ref, got = cli_setup["runs"]["jax", mode], cli_setup["runs"]["port", mode]
    assert _files(ref["out"]) == _files(got["out"])
    assert ref["stats"]["scans"] == got["stats"]["scans"] == N_SCANS
    assert ref["n_full_steps"] == got["n_full_steps"] == 0
    free = moved = unmatched = labels = 0
    for i in range(N_SCANS):
        (rl, rc, rb), (gl, gc, gb) = (_artifacts(r["out"], i)
                                      for r in (ref, got))
        # the logits behind the written files
        logits = ref["steps"][i]["point_logits"][:len(rl)]
        mine = got["steps"][i]["point_logits"][:len(rl)]
        err = np.abs(mine - logits).max(1)
        assert err.max() <= CPU_LOGIT_ABS
        assert (err > LOGIT_TOL).mean() <= CPU_MOVED_SHARE
        moved += int((err > LOGIT_TOL).sum())
        # a label may differ only where the JAX logits' top two lie within
        # twice the logits' bound
        top2 = np.sort(logits[:, 1:], axis=1)
        tie = top2[:, 1] - top2[:, 0] <= 2 * CPU_LOGIT_ABS
        free += int(tie.sum())
        labels += len(rl)
        assert rl.dtype == gl.dtype and rl.shape == gl.shape
        np.testing.assert_array_equal(gl[~tie], rl[~tie])
        # softmax over two logits moves by at most half their difference
        assert gc.dtype == rc.dtype == np.float64 and gc.shape == rc.shape
        assert (np.abs(gc - rc).max(1) <= err / 2 + LOGIT_TOL).all()
        assert set(gb) == set(rb)
        for k in rb:
            assert gb[k].dtype == rb[k].dtype
            assert gb[k].shape[1:] == rb[k].shape[1:]
        # as sets, each side's unmatched boxes: the random weights' scores
        # are nearly flat, so candidates ~1e-7 apart swap places in NMS's
        # order and change the kept set (here not capped at
        # nms_post_maxsize, so its size too); the instance fusion then
        # moves the logits of points near the changed boxes
        # (tools/stream_record.py)
        rd, gd = ({"boxes": b["pred_boxes"], "scores": b["pred_scores"],
                   "labels": b["pred_labels"]} for b in (rb, gb))
        n = max(len(rd["boxes"]), len(gd["boxes"]))
        miss = max(SR.match_boxes(rd, gd, LOGIT_TOL)[0],
                   SR.match_boxes(gd, rd, LOGIT_TOL)[0])
        assert n > 0 and miss <= CPU_BOX_UNMATCHED * n
        unmatched += miss
    print(f"{mode}: {free} of {labels} labels free to differ (JAX top two "
          f"within {2 * CPU_LOGIT_ABS}); "
          f"{moved} points whose logits moved beyond {LOGIT_TOL}; kept "
          f"boxes unmatched {unmatched}")
    assert free < labels // 10


def test_refine_evaluate_visualize_match_jax(cli_setup, tmp_path):
    """On the JAX predict_mos tree: both refine CLIs write the same label
    files; evaluate_mos gives the same numbers on the predicted and the
    refined labels; the visualizer's gating and colours are equal."""
    root = cli_setup["root"]
    pred = cli_setup["runs"]["jax", "default"]["out"]
    outs = {}
    for side, mod in (("jax", jax_refine), ("port", refine)):
        outs[side] = str(tmp_path / side)
        mod.main(["--data_path", root, "--pred", pred, "--out", outs[side],
                  "--sequences", "8", "--n_past_steps", "3"])
    files = _files(outs["jax"])
    assert files == _files(outs["port"]) and len(files) == N_SCANS
    for f in files:
        with open(os.path.join(outs["jax"], f), "rb") as fa, \
                open(os.path.join(outs["port"], f), "rb") as fb:
            assert fa.read() == fb.read(), f
    for p in (os.path.join(pred, "mos_preb"),
              os.path.join(outs["jax"], "mos_preb")):
        ref = jax_evaluate.evaluate(root, p, [8])
        assert evaluate_mos.evaluate(root, p, [8]) == ref
        assert evaluate_mos.main(["--data_path", root, "--pred", p]) == ref
    scan = kitti.read_point_cloud(os.path.join(root, "08", "velodyne",
                                               "000004.bin"))
    _, _, box = _artifacts(pred, 4)
    mos = io.read_pred_labels(os.path.join(
        pred, "mos_preb", "sequences", "08", "predictions", "000004.label"))
    mos[:50] = 2  # some moving points for the colours
    box = dict(box, pred_scores=np.linspace(0.05, 0.95, len(
        box["pred_scores"])).astype(np.float32))
    gated = visualize.gate_boxes(box)
    _tree_equal(jax_visualize.gate_boxes(box), gated)
    # boxes over the scan's points, so that the in-box colours show
    b = gated[0].copy()
    b[:, :2] = scan[:len(b), :2]
    b[:, 3:6] = 4.0
    for mode in ("class", "instance", "ref"):
        np.testing.assert_array_equal(
            visualize.point_colors(scan, mos, b, gated[1], mode),
            jax_visualize.point_colors(scan, mos, b, gated[1], mode))


def test_predict_mos_pod_and_default_guard(cli_setup, tmp_path):
    """--pod (one slot on the CPU) writes the serial run's labels byte for
    byte; a run with neither --ckpt nor --cfg_file exits."""
    base = ["--data_path", cli_setup["root"], "--out", str(tmp_path),
            "--device", "cpu"]
    stats = predict_mos.run(predict_mos.parse_args(
        base + ["--ckpt", cli_setup["pckpt"], "--pod", "--sequences", "8"]))
    assert stats["scans"] == N_SCANS and stats["waves"][0]["sequences"] == [8]
    serial = cli_setup["runs"]["port", "default"]["out"]
    pod = os.path.join(str(tmp_path), cli_setup["cfg"].experiment_id)
    rel = os.path.join("mos_preb", "sequences", "08", "predictions")
    names = sorted(os.listdir(os.path.join(serial, rel)))
    assert len(names) == N_SCANS
    for name in names:
        with open(os.path.join(serial, rel, name), "rb") as fa, \
                open(os.path.join(pod, rel, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    with pytest.raises(SystemExit, match="RANDOM weights"):
        predict_mos.run(predict_mos.parse_args(base))
    assert predict_mos.parse_args([]).device == "cuda"


def test_predict_mos_trace(cli_setup, tmp_path):
    """--trace PATH records the run's spans and counters and writes their
    summary: a step, an NMS copy and a fetch a scan; tracing is off after."""
    path = str(tmp_path / "trace.json")
    stats = predict_mos.main([
        "--data_path", cli_setup["root"], "--out", str(tmp_path / "out"),
        "--device", "cpu", "--ckpt", cli_setup["pckpt"], "--sequences", "8",
        "--trace", path])
    assert stats["scans"] == N_SCANS and not obs.on()
    with open(path) as fh:
        summary = json.load(fh)
    spans, counters = summary["spans"], summary["counters"]
    for name in ("step", "fetch", "nms"):
        assert spans[name]["count"] == N_SCANS, name
    for name in ("push", "motion", "plan", "voxelize", "tail", "detect",
                 "sync.nms", "sync.fetch"):
        assert 0 <= spans[name]["self_ms"] <= spans[name]["incl_ms"], name
    assert counters["pipeline.scans"] == counters["nms.copies"] == N_SCANS
    assert summary["records"] == N_SCANS
