"""The lower_bound cases that the card's kernel test
(test_torch_micro_kernels.py) and the CPU test of the kernel's torch mirror
(test_torch_lower_bound_mirror.py) share: keys and queries made from a seed
with numpy."""

import numpy as np

I32 = np.iinfo(np.int32)

# kind, T, query shape. "random": keys from a narrow range, so that they
# repeat, and the band keys[0] < q <= keys[1]; T around the layout's
# boundaries (2^15 buckets of 2^s keys: s grows past 2^15, 2^16, 2^17 and
# 2^18 keys; the tree has 2^h - 1 splitters) and 2^22 (buckets of 128 keys:
# four halvings before the group). "equal": every key the same.
# "extremes": INT_MIN and INT_MAX among keys and queries. "q_skew" and
# "keys_skew": the queries (so the queries and answers go key by key, not as
# 16-byte quads) or the keys (so the group of 8 is read key by key) start 4
# bytes past a 16-byte boundary.
CASES = [
    ("random", T, qshape)
    for T in (1, 5, 8192, 8193, 32_768, 262_144, 262_145)
    for qshape in ((1000,), (33, 128))
] + [
    ("random", T, (1001,))
    for T in (2, 8191, 32_767, 32_769, 65_535, 65_536, 65_537, 131_073,
              262_143)
] + [
    ("random", 2**22, (24_581,)),
    ("random", 262_144, (1,)),
    ("random", 8192, (1,)),
    ("random", 262_144, (3 * 8192 + 5,)),
    ("equal", 8192, (1000,)),
    ("equal", 262_145, (1000,)),
    ("extremes", 8192, (1000,)),
    ("extremes", 262_145, (1000,)),
    ("q_skew", 8192, (4099,)),
    ("q_skew", 262_144, (4099,)),
    ("keys_skew", 262_144, (4099,)),
    ("keys_skew", 1_000_000, (4099,)),
]


def make_case(kind, T, qshape):
    """(keys (T,), queries of qshape), int32, from a generator seeded by
    T."""
    rng = np.random.default_rng(T)
    n = int(np.prod(qshape))
    if kind == "equal":
        keys = np.full(T, 7, np.int32)
        q = rng.integers(5, 10, n).astype(np.int32)
    elif kind == "extremes":
        third = T // 3 + 1
        keys = np.sort(np.concatenate([
            np.full(third, I32.min), rng.integers(-100, 101, T - 2 * third),
            np.full(third, I32.max)])).astype(np.int32)
        q = rng.integers(-150, 151, n).astype(np.int32)
        q[:6] = [I32.min, I32.min + 1, I32.max, I32.max - 1, 0, -1]
    else:
        # values from a narrow range so that keys repeat
        keys = np.sort(rng.integers(-5 * T, 5 * T + 1, T)).astype(np.int32)
        q = rng.integers(-6 * T - 2, 6 * T + 3, n).astype(np.int32)
        q[:4] = [keys[0], keys[0] + 1, keys[min(1, T - 1)],
                 keys[-1] + 1][:n]
    return keys, q.reshape(qshape)


IDS = [f"{k}-T{T}-{'x'.join(map(str, qs))}" for k, T, qs in CASES]
