"""The orbax checkpoint converter (tests/torch_orbax_convert.py): a tiny
checkpoint that the JAX package saves with orbax (its own init, BN running
statistics drawn away from 0 and 1), converted and loaded by the port. The
loaded model holds the same state as one built by ``load_jax_params`` from
the same trees, and its pipeline's outputs equal that model's bit for bit;
the configuration and step come through."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from insmos_tpu.utils.checkpoint import save_checkpoint as jax_save
from insmos_tpu_torch.pipeline import InferencePipeline
from insmos_tpu_torch.utils.checkpoint import load_checkpoint
from insmos_tpu_torch.utils.params import make_model

from test_torch_model import port_config
from torch_orbax_convert import convert
from torch_port_common import (hdl64_crop_stream, jax_params_np, perturb_bn,
                               tiny_config)

REPO = Path(__file__).resolve().parents[1]


def test_converted_checkpoint_runs_the_jax_weights(tmp_path):
    cfg = tiny_config(window=3)
    params, state = jax_params_np(cfg, seed=3)
    state = perturb_bn(state, seed=3)
    jckpt, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save(jckpt, cfg, params, state, step=7)
    res = convert(jckpt, out)
    pcfg, model, step = load_checkpoint(out, "cpu")
    assert step == res["step"] == 7 and pcfg == port_config(cfg)
    direct = make_model(pcfg, params, state, "cpu")
    a, b = model.state_dict(), direct.state_dict()
    assert a.keys() == b.keys() and len(a) > 100
    for k in a:
        assert torch.equal(a[k], b[k]), k
    scans, tfs, _ = hdl64_crop_stream(2)
    pa = InferencePipeline(pcfg, model, "cpu")
    pb = InferencePipeline(pcfg, direct, "cpu")
    for s, tf in zip(scans, tfs):
        oa, ob = pa.push_scan(s, tf), pb.push_scan(s, tf)
        for k in ("point_logits", "boxes", "scores", "box_mask"):
            assert torch.equal(oa[k], ob[k]), k
    assert oa["point_logits"].abs().max() > 0
    np.testing.assert_array_equal(
        a["motion.stem.conv.w"].numpy(), params["motion"]["stem"]["conv"]["w"])


def test_converter_command_line(tmp_path):
    cfg = tiny_config(window=3)
    params, state = jax_params_np(cfg, seed=4)
    jckpt, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save(jckpt, cfg, params, state, step=2)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_orbax_convert.py"), jckpt,
         out], capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    assert "step 2" in proc.stdout
    _, model, step = load_checkpoint(out, "cpu")
    assert step == 2
    ref = make_model(port_config(cfg), params, state, "cpu").state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
