"""The port's plan-budget replay (insmos_tpu_torch/tools/
validate_plan_budgets.py) on the CPU. The first four steps of the
ref-exact fixture stream at the full default Config, warm-up windows
included: the L2 block plan leaves 12 rows uncovered on step 3 and every
other plan covers every row, the count the port reproduced on the card and
the CPU in its full runs (ROADMAP Queue 3). The span convs are replaced by
zeros: the plans depend on the site sets alone."""

import torch

from insmos_tpu_torch.config import Config
from insmos_tpu_torch.sparse import span_conv as SC
from insmos_tpu_torch.tools import validate_plan_budgets as V


def test_replay_ref_exact_warm_up():
    rows = V.replay(Config(), "ref_exact", 4, "cpu")
    assert len(rows) == 4
    assert V.nonzero("ref_exact", rows) == {3: {"block L2": 12}}


def test_zero_span_convs_is_scoped():
    orig = SC.span_conv_parts
    part = SC.ConvPart(2, 3, 4, 1, 0, 0, 0)
    with V.zero_span_convs():
        out = SC.span_conv_parts(None, torch.ones(5, 8), None, (part,),
                                 torch.zeros(7, 3), None, None, 4)
    assert out.shape == (7, 12) and not out.any()
    assert SC.span_conv_parts is orig
