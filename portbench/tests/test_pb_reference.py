"""The plain reference against the port's CPU route (its plain versions of
the kernels), float32, at a small configuration, in both modes: per-point
logits and kept boxes of every step, warm-up included, a turning drive
(real rotations) and a fixed-frame drive whose window sites shift and
leave the grid."""

import numpy as np
import pytest

from portbench import traffic, weights
from portbench.reference import model as ref
from portbench.tests.pb_common import config_doc, mix, near_scan, small_config


@pytest.mark.parametrize("fixed", [False, True], ids=["refexact", "fixedframe"])
def test_reference_matches_port(fixed):
    from insmos_tpu_torch.nn.model import InsMOSModel
    from insmos_tpu_torch.pipeline import InferencePipeline

    cfg = small_config(fixed, score_thresh=0.1)
    cd = config_doc(cfg)["config"]
    W = cfg.model.n_past_steps
    stream = traffic.Stream(11, mix(), 10**9, fixed, 0.1, 40)
    steps = [near_scan(stream, w) for w in range(7)]
    sd = weights.state_dict(cd)
    # a steeper class head, so that a few dozen boxes clear the gate at
    # this small size with scores far apart (no near-ties for the NMS)
    sd["head.cls.w"] = sd["head.cls.w"] * 30.0
    sd["head.cls.b"][:] = -9.0
    model = InsMOSModel(cfg)
    model.load_state_dict(sd)
    pipe = InferencePipeline(cfg, model, "cpu")
    n_boxes = 0
    for i, (scan, tf) in enumerate(steps):
        if not fixed and i:
            assert not np.allclose(tf[:2, :2], np.eye(2)), "no rotation"
        if fixed and i:
            assert np.abs(tf[:3, 3]).max() > 0.05, "no cache shift"
        out = pipe.push_scan(scan, tf)
        assert int(out["overflow"]["span_overflow"].sum()) == 0
        got = InferencePipeline.fetch(out, len(scan))
        win = [(None, None)] * max(0, W - i - 1) + steps[max(0, i - W + 1):i + 1]
        r = ref.step(cd, sd, [a for a, _ in win], [b for _, b in win],
                     fixed_frame=fixed)
        np.testing.assert_allclose(got["point_logits"], r["point_logits"],
                                   atol=2e-5, rtol=0)
        assert len(got["boxes"]) == len(r["boxes"])
        np.testing.assert_allclose(got["boxes"][:, :6], r["boxes"][:, :6],
                                   atol=2e-4, rtol=0)
        # the yaw is atan2 of the box head's two small outputs (weights of
        # 1e-3): float32 rounding of those moves it by up to ~1e-3 rad
        np.testing.assert_allclose(got["boxes"][:, 6], r["boxes"][:, 6],
                                   atol=1e-2, rtol=0)
        np.testing.assert_allclose(got["scores"], r["scores"], atol=1e-5)
        np.testing.assert_array_equal(got["labels"], r["labels"])
        n_boxes += len(r["boxes"])
    assert n_boxes > 0, "no kept boxes: the fusion went untested"

