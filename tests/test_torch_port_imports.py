"""The PyTorch port imports no jax and nothing of the JAX package, and its
parameter init mirrors the JAX package's tree exactly."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from insmos_tpu.config import Config
from insmos_tpu.nn import InsMOSModel
from insmos_tpu_torch.config import Config as PortConfig
from insmos_tpu_torch.nn.model import InsMOSModel as TorchModel
from insmos_tpu_torch.utils.params import init_params, load_jax_params

from torch_port_common import cpu_threads

REPO = Path(__file__).resolve().parents[1]


def _run(script):
    """``script`` in a fresh interpreter at the repo root, with the torch
    threads of this test process."""
    return subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ,
                                   OMP_NUM_THREADS=str(cpu_threads())))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["insmos_tpu"] = None  # and so does any of the JAX package
import insmos_tpu_torch
names = [m.name for m in pkgutil.walk_packages(insmos_tpu_torch.__path__,
                                               "insmos_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "insmos_tpu")
       and sys.modules[m]]
print(len(names), "modules", bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    res = _run(_IMPORT_ALL)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "modules []" in res.stdout


_INCREMENTAL = r"""
import dataclasses, sys
sys.modules["jax"] = None
sys.modules["insmos_tpu"] = None
import numpy as np
import chip_smoke
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.data.hdl64 import make_fixed_frame_stream
from insmos_tpu_torch.pipeline import InferencePipeline
from insmos_tpu_torch.utils.params import init_params, make_model
cfg = chip_smoke.incremental_config(Config().tiny(points=512, max_voxels=1024))
cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                         n_past_steps=2))
p, s = init_params(cfg, np.random.default_rng(0))
pipe = InferencePipeline(cfg, make_model(cfg, p, s, "cpu"), "cpu")
scans, tfs, _ = make_fixed_frame_stream(cfg, 2)
for sc, tf in zip(scans, tfs):
    out = pipe.push_scan(sc, tf)
assert pipe.n_full_steps == 0 and "stem_cache" in pipe._buf
assert bool(out["point_logits"].isfinite().all())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "insmos_tpu")
       and sys.modules[m]]
print("incremental ok", bad)
assert not bad, bad
"""


def test_incremental_pipeline_runs_without_jax():
    """The incremental mode's pipeline, fixed-frame stream and chip_smoke's
    configs, with jax and the JAX package blocked."""
    res = _run(_INCREMENTAL)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "incremental ok []" in res.stdout


_CLI = r"""
import os, sys, tempfile
sys.modules["jax"] = None
sys.modules["insmos_tpu"] = None
import numpy as np
from insmos_tpu_torch.cli import evaluate_mos, predict_mos, refine
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.data.synthetic import write_synthetic_sequence
from insmos_tpu_torch.utils.checkpoint import save_checkpoint_from_trees
from insmos_tpu_torch.utils.params import init_params
cfg = Config().tiny(points=2048, max_voxels=1024)
with tempfile.TemporaryDirectory() as tmp:
    write_synthetic_sequence(tmp, seq=8, n_scans=2, seed=0, n_ground=600,
                             n_per_obj=40)
    save_checkpoint_from_trees(tmp + "/ckpt", cfg,
                               *init_params(cfg, np.random.default_rng(0)))
    stats = predict_mos.main(["--ckpt", tmp + "/ckpt", "--data_path", tmp,
                              "--sequences", "8", "--out", tmp + "/out",
                              "--device", "cpu", "--fixed-frame"])
    refine.main(["--data_path", tmp, "--pred", tmp + "/out/InsMOS",
                 "--out", tmp + "/ref", "--sequences", "8"])
    res = evaluate_mos.evaluate(tmp, tmp + "/ref/mos_preb", [8])
assert stats["scans"] == 2 and 0.0 <= res["iou_static"] <= 1.0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "insmos_tpu")
       and sys.modules[m]]
print("cli ok", bad)
assert not bad, bad
"""


def test_cli_runs_without_jax():
    """predict_mos (--fixed-frame, from a port checkpoint), refine and
    evaluate_mos on a synthetic sequence, with jax and the JAX package
    blocked."""
    res = _run(_CLI)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "cli ok []" in res.stdout


_SCALE_OUT = r"""
import os, sys, tempfile
sys.modules["jax"] = None
sys.modules["insmos_tpu"] = None
import numpy as np
import torch
from insmos_tpu_torch import native
from insmos_tpu_torch.cli import predict_mos
from insmos_tpu_torch.config import Config
from insmos_tpu_torch.data.sample import to_device
from insmos_tpu_torch.data.synthetic import write_synthetic_sequence
from insmos_tpu_torch.ops.points_in_boxes import points_in_instance_boxes
from insmos_tpu_torch.parallel import World, init_world, shard_batch
from insmos_tpu_torch.pipeline import PodInferencePipeline
from insmos_tpu_torch.train.optim import make_optimizer
from insmos_tpu_torch.train.step import TrainState, make_train_step
from insmos_tpu_torch.utils.checkpoint import save_checkpoint_from_trees
from insmos_tpu_torch.utils.params import init_params, make_model
cfg = Config().tiny(points=2048, max_voxels=1024)
p, s = init_params(cfg, np.random.default_rng(0))
with tempfile.TemporaryDirectory() as tmp:
    write_synthetic_sequence(tmp, seq=8, n_scans=2, seed=0, n_ground=600,
                             n_per_obj=40)
    save_checkpoint_from_trees(tmp + "/ckpt", cfg, p, s)
    stats = predict_mos.main(["--ckpt", tmp + "/ckpt", "--data_path", tmp,
                              "--sequences", "8", "--out", tmp + "/out",
                              "--device", "cpu", "--pod"])
    scan = tmp + "/08/velodyne/000000.bin"
    buf, n = native.load_window([scan], np.eye(4, dtype=np.float32)[None], 64)
    ref, m = native.load_window_plain([scan], np.eye(4, dtype=np.float32)[None],
                                      64)
assert stats["scans"] == 2 and np.array_equal(buf, ref) and n[0] == 64
pod = PodInferencePipeline(cfg, make_model(cfg, p, s, "cpu"), ["cpu"], 2)
scans = [np.random.default_rng(i).uniform(-5, 5, (300, 4)).astype(np.float32)
         for i in range(2)]
out = pod.push_scans(scans)
assert out["point_logits"].shape[0] == 2
world = init_world("cpu")
assert world == World()
model = make_model(cfg, p, s, "cpu")
ts = TrainState(model, *make_optimizer(model, cfg, 10))
W, P = cfg.model.n_past_steps, cfg.runtime.max_points_per_scan
rng = np.random.default_rng(0)
batch = {"points": rng.uniform(-5, 5, (2, W, P, 4)).astype(np.float32),
         "num_points": np.full((2, W), P // 2, np.int32),
         "scan_mask": np.ones((2, W), bool),
         "labels": rng.integers(0, 3, (2, W, P)).astype(np.int32),
         "gt_boxes": np.zeros((2, cfg.model.head.max_objs, 8), np.float32),
         "num_boxes": np.zeros(2, np.int32)}
ts, m = make_train_step(model, world)(ts, to_device(shard_batch(world, batch),
                                                    "cpu"))
assert bool(torch.isfinite(m["loss"]))
ids = points_in_instance_boxes(torch.zeros((1, 3)),
                               torch.tensor([[0, 0, 0, 2, 2, 2, 0, 1.0]]), 3)
assert ids.tolist() == [[1, 0, 0]]
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "insmos_tpu")
       and sys.modules[m]]
print("scale-out ok", bad)
assert not bad, bad
"""


def test_pod_dp_native_and_boxes_run_without_jax():
    """predict_mos --pod and the pod pipeline, a train step in the world
    of one process, the native loader and points_in_instance_boxes, with
    jax and the JAX package blocked."""
    res = _run(_SCALE_OUT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "scale-out ok []" in res.stdout


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)


@pytest.mark.parametrize("cfg_name", ["default", "tiny"])
def test_init_params_matches_jax_init(cfg_name):
    cfg = Config() if cfg_name == "default" else Config().tiny()
    pcfg = PortConfig() if cfg_name == "default" else PortConfig().tiny()
    ref_p, ref_s = jax.eval_shape(InsMOSModel(cfg).init, jax.random.PRNGKey(0))
    p, s = init_params(pcfg, np.random.default_rng(0))
    for ref, got in ((ref_p, p), (ref_s, s)):
        assert (jax.tree_util.tree_structure(ref)
                == jax.tree_util.tree_structure(got))
        for (path, r), (_, g) in zip(_leaves(ref)[0], _leaves(got)[0]):
            assert g.shape == r.shape and g.dtype == r.dtype, (path, g.shape,
                                                               r.shape)


def test_load_jax_params_fills_every_module_tensor():
    cfg = PortConfig().tiny()
    p, s = init_params(cfg, np.random.default_rng(1))
    sd = load_jax_params(p, s, "cpu")
    model = TorchModel(cfg)
    ref = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].shape == v.shape and sd[k].dtype == torch.float32, k
    model.load_state_dict(sd, strict=True)
    # BN running stats are drawn away from (0, 1)
    assert float(model.motion.stem.bn.var.min()) != 1.0
    # the transposed conv's kernel is flipped into torch's layout
    w = p["bev"]["deblocks"][0]["conv"]["w"]
    np.testing.assert_array_equal(
        model.bev.deblocks[0].conv.w.detach().numpy()[:, :, 0, 1],
        w[1, 0])
