"""The PyTorch port imports no jax and nothing of the JAX package, and its
parameter init mirrors the JAX package's tree exactly."""

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

REPO = Path(__file__).resolve().parents[1]

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
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "modules []" in res.stdout


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
