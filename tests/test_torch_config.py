"""The port's own copies of the JAX package's jax-free modules hold the same
values: its Config (default and ``tiny()``) and the HDL-64E raycast fixture
(bit for bit from the same seed)."""

import dataclasses

import numpy as np
import pytest

from insmos_tpu import config as jax_config
from insmos_tpu.data import hdl64 as jax_hdl64
from insmos_tpu_torch import config as port_config
from insmos_tpu_torch.data import hdl64 as port_hdl64


@pytest.mark.parametrize("variant", ["default", "tiny", "tiny_small"])
def test_config_equals_jax(variant):
    def make(mod):
        cfg = mod.Config()
        if variant == "tiny":
            cfg = cfg.tiny()
        elif variant == "tiny_small":
            cfg = cfg.tiny(points=512, max_voxels=1024)
        return cfg

    ref, got = make(jax_config), make(port_config)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.data.grid_size == ref.data.grid_size
    assert got.model.motionnet.grid_size == ref.model.motionnet.grid_size


def test_config_classes_match_jax():
    """Every sub-dataclass has the same fields, in the same order."""
    for name in ("DataConfig", "MotionNetConfig", "BEVConfig", "HeadConfig",
                 "PostProcessConfig", "ModelConfig", "TrainConfig",
                 "RuntimeConfig", "Config"):
        ref = [f.name for f in dataclasses.fields(getattr(jax_config, name))]
        got = [f.name for f in dataclasses.fields(getattr(port_config, name))]
        assert got == ref, name


@pytest.mark.parametrize("seed", [0, 1])
def test_hdl64_fixture_bit_identical(seed):
    rngs = [np.random.default_rng(seed) for _ in range(2)]
    worlds = [mod._make_world(rng)
              for mod, rng in zip((jax_hdl64, port_hdl64), rngs)]
    for a, b in zip(*worlds):
        np.testing.assert_array_equal(a, b)
    for step in range(2):
        ego = np.array([1.1, 0.05]) * step
        (pa, ma), (pb, mb) = (
            mod.raycast_scan(w, ego, step, rng)
            for mod, w, rng in zip((jax_hdl64, port_hdl64), worlds, rngs))
        assert pa.dtype == pb.dtype == np.float32 and len(pa) > 100_000
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ma, mb)
