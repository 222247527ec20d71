"""The yardstick's arithmetic: the rulebook's pairs and useful work
against hand counts, the end-to-end statistics over all scans (a window
with a stall), the idle share as a union, and the trace reader's
charging of device activities to host ranges."""

import numpy as np
import torch

from portbench import stats, trace, work
from portbench.reference import model as ref


def _sites(pts, dims=(8, 8, 8)):
    return ref.Sites.unique(torch.tensor(pts, dtype=torch.int64), dims)


def test_subm_pairs_by_hand():
    # three sites on a line: the 3^3 subm conv pairs each site with itself
    # and its neighbours, 3 + 2 + 2 = 7 pairs in all
    s = _sites([[1, 1, 1], [2, 1, 1], [3, 1, 1], [6, 6, 6]])
    tape = ref.Tape()
    net = ref.Net({}, "float32", tape)
    x = ref.T(s, torch.ones((4, 2)))
    x.tid = tape.new(4)
    y = net.conv(x, s, torch.ones((27, 2, 5)), ref.subm_taps((3, 3, 3)),
                 (1, 1, 1))
    assert sum(int(o.numel()) for _, o in tape.ops[-1]["pairs"]) == 3 + 2 + 2 + 1
    # every output row: sum over its neighbours of 2 channels x ones
    np.testing.assert_allclose(y.feats[:, 0].numpy(), [4, 6, 4, 2])
    tape.roots = [y.tid]
    (c,) = work.cone(tape)
    assert c["pairs"] == 8 and c["rows_in"] == 4 and c["rows_out"] == 4
    w = work.step_work([c], 0.0, 2)
    assert w["flops"] == 2 * 8 * 2 * 5
    assert w["span"]["bytes"] == 4 * 2 * 2 + 4 * 5 * 4 + 27 * 2 * 5 * 2


def test_cone_counts_only_needed_rows():
    # a conv whose output is read at one row: only that row's pairs count
    s = _sites([[1, 1, 1], [2, 1, 1], [3, 1, 1]])
    tape = ref.Tape()
    net = ref.Net({}, "float32", tape)
    x = ref.T(s, torch.ones((3, 1)))
    x.tid = tape.new(3)
    y = net.conv(x, s, torch.ones((27, 1, 1)), ref.subm_taps((3, 3, 3)),
                 (1, 1, 1))
    out = net.gather(y, ref.Points(1, "cpu"), torch.tensor([0]))
    tape.roots = [out.tid]
    (c,) = work.cone(tape)
    assert (c["pairs"], c["rows_in"], c["rows_out"]) == (2, 2, 1)


def test_strided_sites_by_hand():
    # spconv k3 s2 p1: input x = 3 reaches outputs o with 2o - 1 <= 3 <= 2o + 1
    s = _sites([[3, 0, 0]])
    out = ref.strided_sites(s, (3, 3, 3), (2, 2, 2), (1, 1, 1), (4, 4, 4))
    assert sorted(map(tuple, out.coords.tolist())) == [
        (1, 0, 0), (2, 0, 0)]


def test_rate_and_tail_over_all_scans():
    # 99 steps of 300 ms and one stall of 3 s: the tail sees the stall's
    # share, the rate every scan over the whole window
    lat = [0.3] * 99 + [3.0]
    assert stats.percentile(lat, 90) == 0.3
    # between the two order statistics, as numpy's default
    assert abs(stats.percentile(lat, 99.5) - (0.3 + 2.7 * 0.505)) < 1e-12
    assert abs(stats.percentile(lat, 99.5) - np.percentile(lat, 99.5)) < 1e-12
    lat = [0.3] * 85 + [3.0] * 15
    assert stats.percentile(lat, 90) == 3.0
    window = sum(lat)
    assert abs(len(lat) / window - 100 / (85 * 0.3 + 15 * 3.0)) < 1e-12
    assert stats.percentile([5.0], 90) == 5.0


def test_idle_share_is_a_union():
    iv = [(0.0, 4.0), (2.0, 6.0), (8.0, 9.0), (8.5, 8.7)]
    assert stats.union_length(iv) == 7.0
    assert stats.gaps(iv, 0.0, 10.0) == [(6.0, 8.0), (9.0, 10.0)]


def test_trace_reader_charges_ranges():
    X = "X"
    ev = [
        dict(ph=X, cat="user_annotation", name="pb.step", ts=0, dur=1000),
        dict(ph=X, cat="user_annotation", name="pb.motion", ts=100, dur=300),
        dict(ph=X, cat="cpu_op", name="insmos::span_conv", ts=150, dur=50),
        dict(ph=X, cat="user_annotation", name="pb.tail", ts=500, dur=300),
        dict(ph=X, cat="user_annotation", name="pb.fetch", ts=850, dur=100),
        dict(ph=X, cat="cuda_runtime", name="cudaLaunchKernel", ts=160, dur=5,
             args=dict(correlation=1)),
        dict(ph=X, cat="cuda_runtime", name="cudaLaunchKernel", ts=600, dur=5,
             args=dict(correlation=2)),
        dict(ph=X, cat="cuda_runtime", name="cudaMemcpyAsync", ts=860, dur=5,
             args=dict(correlation=3)),
        dict(ph=X, cat="kernel", name="span_mma_kernel", ts=200, dur=100,
             args=dict(correlation=1)),
        dict(ph=X, cat="kernel", name="glue", ts=250, dur=100,
             args=dict(correlation=2)),
        dict(ph=X, cat="gpu_memcpy", name="Memcpy DtoH", ts=870, dur=30,
             args=dict(correlation=3)),
    ]
    r = trace.read(ev, [("pb.motion", "motion"), ("pb.tail", "tail")])
    assert r["steps"] == 1 and abs(r["window_s"] - 1e-3) < 1e-12
    assert abs(r["busy_s"] - 180e-6) < 1e-12  # 200-350 as one, and 30
    assert r["activities"] == 3
    cs = r["charged_s"]
    assert abs(cs["pb.motion"] - 100e-6) < 1e-12
    assert abs(cs["insmos::span_conv"] - 100e-6) < 1e-12
    assert abs(cs["pb.tail"] - 100e-6) < 1e-12
    assert abs(cs["pb.fetch"] - 30e-6) < 1e-12
    # the longest idle gap, 350-870 us, falls at 610 us, inside pb.tail
    assert r["idle_gaps"][0][0] == "tail"
    assert abs(r["idle_gaps"][0][1] - 520e-6) < 1e-12
    assert r["device_ops"][0][0] in ("span_mma_kernel", "glue")
