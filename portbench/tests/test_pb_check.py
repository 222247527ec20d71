"""The check fails what it must. At a small configuration on the CPU:
the control (the reference with float8 matmul operands) is not correct
under the configurations' limits; and a run through the harness, with the
chip look skipped and the timed path broken underneath, comes out not
correct for each fault a cell can have (the pipeline's state left
unchanged, an answer altered where it is produced, half of a pod's slots
left out). One chip: no exchange between chips to leave out. On the card,
the control at a cell's full size (three seeds)."""

import json
import os

import numpy as np
import pytest

from portbench import check, traffic, weights
from portbench.reference import model as ref
from portbench.run import compared_steps, run
from portbench.tests.pb_common import ROOT, config_doc, mix, near_scan, small_config


def _limits(name="insmos-n10-refexact"):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as fh:
        return json.load(fh)["check"]["limits"]


def test_control_fails_at_small_size():
    cfg = small_config(False, score_thresh=0.0102)
    cd = config_doc(cfg)["config"]
    W = cfg.model.n_past_steps
    stream = traffic.Stream(5, mix(), 10**9, False, 0.1, 40)
    steps = [near_scan(stream, w) for w in range(W + 2)]
    sd = weights.state_dict(cd)
    pairs = []
    for i in (W, W + 1):
        win = steps[i - W + 1:i + 1]
        args = ([a for a, _ in win], [b for _, b in win])
        r = ref.step(cd, sd, *args, fixed_frame=False)
        c = ref.step(cd, sd, *args, fixed_frame=False, dtype="float8_e4m3fn")
        pairs.append((c, r))
    numbers = check.compare(pairs, cd["model"]["post"]["score_thresh"])
    ok, _ = check.verdict(numbers, _limits(), check.NAMES)
    assert not ok, numbers


def _run_broken(monkeypatch, fault, streams=1):
    from insmos_tpu_torch.pipeline import InferencePipeline, PodInferencePipeline

    if fault == "state_unchanged":
        first = {}
        orig = InferencePipeline.push_scan

        def push_scan(self, scan, tf=None):
            out = orig(self, scan, tf)
            return first.setdefault("out", out)
        monkeypatch.setattr(InferencePipeline, "push_scan", push_scan)
    elif fault == "answer_altered":
        orig = InferencePipeline.fetch

        def fetch(out, n_raw):
            host = orig(out, n_raw)
            host["point_logits"][::7] *= -1.0
            host["boxes"][:, 0] += 3.0
            return host
        monkeypatch.setattr(InferencePipeline, "fetch", staticmethod(fetch))
    elif fault == "half_the_slots":
        orig = PodInferencePipeline.push_scans

        def push_scans(self, scans, tfs=None):
            half = len(scans) // 2
            return orig(self, list(scans[:half]) + [None] * (len(scans) - half),
                        tfs)
        monkeypatch.setattr(PodInferencePipeline, "push_scans", push_scans)
    cfg = small_config(False)
    doc = config_doc(cfg, _limits())
    m = mix("drive" if streams == 1 else "pod8", streams=streams)
    res, lines = run(doc, m, 2**31 + 77, 0.1, False, [], device="cpu")
    return res


@pytest.mark.parametrize("fault,streams", [("state_unchanged", 1),
                                           ("answer_altered", 1),
                                           ("half_the_slots", 2)])
def test_broken_path_is_not_correct(monkeypatch, fault, streams):
    res = _run_broken(monkeypatch, fault, streams)
    assert res["compared"]["steps"] > 0
    assert res["correct"] is False, res["check"]


def test_sound_path_is_correct():
    cfg = small_config(False)
    res, _ = run(config_doc(cfg, _limits()), mix(), 2**31 + 77, 0.1, False,
                 [], device="cpu")
    assert res["correct"] is True, res["check"]
    assert list(res)[-1] == "check"
    # every scan of the closed loop is served; the gates' scans are inexact
    assert res["failed"] == 0
    assert 0 <= res["inexact"] <= res["attempted"]


@pytest.mark.gpu
def test_control_fails_at_cell_size():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.calibrate import readings
    from portbench.run import cell_files

    _, doc, m, _ = cell_files(ROOT, "refexact-drive")
    for seed in (101, 102, 103):
        row = readings(doc, m, seed, 8.0, True)
        assert row["compared"] > 0, row
        ok, _ = check.verdict(row["control"], doc["check"]["limits"],
                              check.NAMES)
        assert not ok, row
        ok, _ = check.verdict(row["program"], doc["check"]["limits"],
                              check.NAMES)
        assert ok, row


def _outputs(rng, n=600, k=6):
    boxes = np.concatenate([rng.uniform(-20, 20, (k, 2)),
                            rng.uniform(-1.5, -0.5, (k, 1)),
                            rng.uniform(0.8, 4.0, (k, 3)),
                            rng.uniform(-3, 3, (k, 1))], axis=1)
    boxes[:, 0] += np.arange(k) * 50.0  # boxes far apart
    return dict(point_logits=rng.normal(0, 2, (n, 3)).astype(np.float32),
                boxes=boxes.astype(np.float32),
                scores=rng.uniform(0.3, 0.9, k).astype(np.float32),
                labels=rng.integers(1, 4, k).astype(np.int32))


def _left_out(n):
    return dict(point_logits=np.zeros((n, 3), np.float32),
                boxes=np.zeros((0, 7), np.float32),
                scores=np.zeros(0, np.float32), labels=np.zeros(0, np.int32))


@pytest.mark.parametrize("seed", [3, 2**31 + 77, 3500000001, 4000000007,
                                  123456789])
def test_pod8_half_the_slots_left_out_is_not_correct(seed):
    """At S = 8 the draw compares a step of every slot, whatever the seed
    and the failed steps, so a pod with half its slots left out (or any
    one slot wrong) is not correct, and the sound pod is."""
    S, n_steps = 8, 62
    rng = np.random.default_rng(seed)
    bad = (rng.uniform(size=(n_steps, S)) < 0.3).tolist()
    window = range(12, n_steps)
    picked = compared_steps(bad, window, seed, S)
    assert sorted(i for _, i in picked) == list(range(S))
    assert all(not bad[s][i] for s, i in picked)
    gone = set(rng.permutation(S)[:S // 2].tolist())
    sound, broken = [], []
    for s, i in picked:
        r = _outputs(np.random.default_rng([seed, s, i]))
        got = {k: v.copy() for k, v in r.items()}
        got["point_logits"] += 1e-3
        sound.append((got, r))
        broken.append((_left_out(len(r["point_logits"])) if i in gone
                       else got, r))
    ok, shown = check.verdict(check.compare(sound, 0.1), _limits(),
                              check.NAMES)
    assert ok, shown
    ok, shown = check.verdict(check.compare(broken, 0.1), _limits(),
                              check.NAMES)
    assert not ok, shown


@pytest.mark.parametrize("fault", ["size_not_exp", "l_w_swapped",
                                   "score_scaled", "z_shifted"])
def test_box_faults_fail_the_matched_pair_numbers(fault):
    """A fault of the head's decode that leaves the boxes' centres where
    they were fails the numbers of the matched pairs."""
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(4):
        r = _outputs(rng)
        got = {k: v.copy() for k, v in r.items()}
        if fault == "size_not_exp":
            got["boxes"][:, 3:6] = np.log(r["boxes"][:, 3:6])
        elif fault == "l_w_swapped":
            got["boxes"][:, 3:5] = r["boxes"][:, 4:2:-1]
        elif fault == "score_scaled":
            got["scores"] = r["scores"] * 0.8
        else:
            got["boxes"][:, 2] += 0.5 * r["boxes"][:, 5]
        pairs.append((got, r))
    numbers = check.compare(pairs, 0.1)
    assert numbers["box_miss_share"] == 0.0
    ok, shown = check.verdict(numbers, _limits(), check.NAMES)
    assert not ok, shown
