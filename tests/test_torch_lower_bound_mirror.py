"""The lower_bound kernel's layout and index arithmetic, mirrored in torch
(insmos_tpu_torch/tools/micro_kernels.py: lower_bound_layout,
lower_bound_tree, lower_bound_mirror), against lower_bound_plain on the CPU
over the cases the card's kernel test runs: bit for bit. ``wavefronts``
models the shared-memory cost of the kernel's descent; on the probes' data:

    python -c "import sys; sys.path.insert(0, 'tests'); \
        import test_torch_lower_bound_mirror as t; print(t.probe_wavefronts())"
"""

import lower_bound_cases as LBC
import pytest
import torch

from insmos_tpu_torch.tools import micro_kernels as MK


@pytest.mark.parametrize("kind,T,qshape", LBC.CASES, ids=LBC.IDS)
def test_lower_bound_mirror_matches_plain(kind, T, qshape):
    keys, q = (torch.from_numpy(a) for a in LBC.make_case(kind, T, qshape))
    got = MK.lower_bound_mirror(keys, q)
    assert got.dtype == torch.int32 and got.shape == q.shape
    assert torch.equal(got, MK.lower_bound_plain(keys, q))


@pytest.mark.parametrize("T,s,h", [
    (1, 0, 0), (2, 0, 1), (8192, 0, 13), (8193, 0, 14), (32_768, 0, 15),
    (32_769, 1, 15), (262_144, 3, 15), (262_145, 4, 15), (2**22, 7, 15),
    (2**30, 15, 15)])
def test_lower_bound_layout(T, s, h):
    """At most 2^15 buckets of 2^s keys, s the least that allows it, and a
    tree of 2^h - 1 >= buckets - 1 splitters."""
    assert MK.lower_bound_layout(T) == (s, h)
    buckets = -(-T // 2**s)
    assert buckets <= 2**15 and (s == 0 or -(-T // 2**(s - 1)) > 2**15)
    assert 2**h >= buckets and (h == 0 or 2**(h - 1) < buckets)


@pytest.mark.parametrize("h", [1, 2, 5, 13, 15])
def test_tree_slot_inverts_tree_rank(h):
    """Every BFS node's in-order rank, and back: a permutation of
    [1, 2^h)."""
    i = torch.arange(1, 2**h)
    r = MK.tree_rank(i, h)
    assert torch.equal(r.sort().values, i)
    assert torch.equal(MK.tree_slot(r, h), i)


def wavefronts(keys, q):
    """Shared-memory wavefronts of the kernel's descent, per level: the mean
    over its warp-wide loads of the most distinct words any one of the 32
    banks serves (a thread holds four adjacent queries, so a load takes
    query j of 32 adjacent quads). Counted from the data; the queries are
    cut to a multiple of 128."""
    _, h = MK.lower_bound_layout(keys.numel())
    tree = MK.lower_bound_tree(keys)
    v = q.reshape(-1)[:q.numel() // 128 * 128].long()
    node = torch.ones_like(v)
    out = []
    for _ in range(h):
        a = node.reshape(-1, 32, 4).transpose(1, 2).reshape(-1, 32)
        word = a.sort(dim=1).values
        new = torch.ones_like(word, dtype=torch.bool)
        new[:, 1:] = word[:, 1:] != word[:, :-1]
        per_bank = torch.zeros((a.shape[0], 32), dtype=torch.int64)
        per_bank.scatter_add_(1, word % 32, new.long())
        out.append(float(per_bank.max(dim=1).values.double().mean()))
        node = 2 * node + (tree[node] < v).long()
    return out


def probe_wavefronts():
    """Wavefronts a warp of queries, summed over the levels, on T2's and
    T6's keys and queries (the ports of tools/micro_pallas.py and
    micro_pallas2.py)."""
    from insmos_tpu_torch.tools import micro_pallas as MP
    from insmos_tpu_torch.tools import micro_pallas2 as MP2

    _, _, k2, q2, _, _ = MP.make_case()
    _, _, _, k6, q6 = MP2.make_case()
    return {name: sum(wavefronts(torch.from_numpy(k), torch.from_numpy(q)))
            for name, k, q in (("T2", k2, q2), ("T6", k6, q6))}


def test_lower_bound_wavefronts():
    """The descent's shared-memory wavefronts: one a level while a level
    fits one 128-byte row (the top six), ~3.5 at the bottom for random
    queries (32 lanes in 32 banks), one everywhere for equal queries."""
    keys, q = (torch.from_numpy(a)
               for a in LBC.make_case("random", 8192, (32, 128)))
    w = wavefronts(keys, q)
    assert len(w) == 13 and w[:6] == [1.0] * 6
    assert all(1.0 <= x <= 32.0 for x in w) and 3.0 < w[-1] < 4.0
    same = torch.full((4096,), int(keys[100]), dtype=torch.int32)
    assert wavefronts(keys, same) == [1.0] * 13
