"""Plain reference of one InsMOS streaming step, in PyTorch, for the
benchmark's check of what the timed path produced.

It imports nothing of the program. It takes the same scans, transforms and
weights (a state dict the benchmark made) and works out everything the
program derives from them again: the window, every site set, every conv's
pairs, the boxes. Sparse convs are exact rulebook convs over coordinate
sets (a sorted key per site and a binary search per tap): no capacities,
no span plans, no pruning. A scan on which the program dropped a point or
left a conv row uncovered is not compared (the harness counts it as
failed), so the reference needs none of those limits.

Semantics, as the two streaming modes define them:

- MotionNet is a 4D sparse UNet over (x, y, z, t) sites, t the slot of the
  scan in the window of W. Stem: subm (5,5,5,1) on a constant 0.5 input;
  down1-3: (2,2,2,1) stride (2,2,2,1); blocks: residual 3^4 subm; up5-7:
  the transposed (2,2,2,1) conv onto the finer level's sites, each
  concatenated [up, lateral] into the next block; a 1x1 head. Only the
  current scan's logits are read, at its points' level-1 sites.
- ref-exact: each step rolls the stored window and re-expresses it by the
  step's rigid transform in float32 (the stored points carry every
  earlier transform), then builds every site set from the points.
- fixed-frame: a scan's level-1 sites are its voxels when it arrived,
  moved by each later step's integer-voxel translation; a site is kept
  while it stays inside the grid (one that leaves is gone, and sites that
  enter the crop across its edge are not added). Its stem output is the
  stem over the scan's own sites at arrival.
- The tail: the current scan voxelized at 0.1 m (mean of a voxel's first
  five points, in point order) with its motion logits, the 3D UNet
  (spconv strides, pad 1), the z-only conv to the dense BEV, the 2D
  backbone, the CenterPoint head, decode, greedy rotated NMS, and the
  instance fusion of the kept boxes into the decoder at every level.

Matmul operands are rounded to ``dtype`` and multiplied in float32, as the
configuration's compute dtype states; ``float8_e4m3fn`` gives the check's
control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .nms import greedy_rotated_nms


# ------------------------------------------------------------ sites, tape
class Sites:
    """A sorted, duplicate-free set of integer coordinates (N, D) inside
    ``dims``, with its int64 keys (x fastest)."""

    def __init__(self, coords: torch.Tensor, dims):
        self.dims = tuple(int(d) for d in dims)
        keys = _key(coords, self.dims)
        keys, order = torch.sort(keys)
        self.keys = keys
        self.coords = coords[order]

    @classmethod
    def unique(cls, coords, dims):
        inside = _inside(coords, dims)
        c = torch.unique(coords[inside], dim=0)
        return cls(c, dims)

    def __len__(self):
        return int(self.keys.shape[0])

    def find(self, q: torch.Tensor) -> torch.Tensor:
        """Row of each query coordinate, -1 where it is not a site."""
        ok = _inside(q, self.dims)
        k = _key(torch.where(ok[:, None], q, 0), self.dims)
        pos = torch.searchsorted(self.keys, k).clamp(max=max(len(self) - 1, 0))
        hit = ok & (len(self) > 0)
        if len(self):
            hit = hit & (self.keys[pos] == k)
        return torch.where(hit, pos, -1)


class Points:
    """The rows of a scan's points (no coordinates): what a gather onto
    per-point outputs is indexed by."""

    def __init__(self, n: int, device):
        self.keys = torch.arange(n, device=device)

    def __len__(self):
        return int(self.keys.shape[0])


def _key(coords, dims):
    k = torch.zeros(coords.shape[0], dtype=torch.int64, device=coords.device)
    for d in reversed(range(len(dims))):
        k = k * dims[d] + coords[:, d].to(torch.int64)
    return k


def _inside(coords, dims):
    lim = torch.tensor(dims, dtype=coords.dtype, device=coords.device)
    return ((coords >= 0) & (coords < lim)).all(dim=1)


class Tape:
    """What a step computed, for the benchmark's count of useful work:
    each op's output and input tensors, and for convs their pairs."""

    def __init__(self):
        self.ops = []
        self.sizes = {}
        self._next = 0

    def new(self, n: int) -> int:
        self._next += 1
        self.sizes[self._next] = n
        return self._next


class T:
    """Features on a site set, with the tape id of the tensor."""

    def __init__(self, sites: Sites, feats: torch.Tensor, tid: int = 0):
        self.sites, self.feats, self.tid = sites, feats, tid


class Net:
    """The step's arithmetic: weights by state-dict name, the rounding of
    matmul operands, and the tape (None: record nothing)."""

    def __init__(self, sd: dict, dtype: str, tape: Tape | None = None):
        self.sd = sd
        self.dt = getattr(torch, dtype)
        self.tape = tape

    def rnd(self, x):
        if self.dt == torch.float32:
            return x.float()
        if self.dt.itemsize == 1:
            x = x.clamp(-448.0, 448.0)
        return x.to(self.dt).float()

    def _out(self, sites, feats, kind, ins, **kw):
        tid = 0
        if self.tape is not None:
            tid = self.tape.new(len(sites))
            self.tape.ops.append(dict(kind=kind, out=tid,
                                      ins=[t.tid for t in ins], **kw))
        return T(sites, feats, tid)

    # -- convs
    def conv(self, x: T, out: Sites, w, taps, stride, span=True, name=""):
        """out[o] = sum_k x[o * stride + taps[k]] @ w[k] over the taps
        whose input is a site (stride as a tuple, taps (K, D))."""
        w = self.rnd(w)
        f = self.rnd(x.feats)
        dev = f.device
        s = torch.tensor(stride, dtype=torch.int64, device=dev)
        acc = torch.zeros((len(out), w.shape[-1]), dtype=torch.float32,
                          device=dev)
        pairs = []
        base = out.coords * s
        for k in range(w.shape[0]):
            idx = x.sites.find(base + taps[k].to(dev))
            o = torch.nonzero(idx >= 0)[:, 0]
            i = idx[o]
            if o.numel():
                acc[o] += f[i] @ w[k]
            if self.tape is not None:
                pairs.append((i, o))
        return self._out(out, acc, "conv", [x], pairs=pairs,
                         cin=w.shape[1], cout=w.shape[2], span=span,
                         name=name)

    def inverse(self, x: T, fine: Sites, w, kernel, stride, pad, name=""):
        """The transposed conv of a strided conv (kernel, stride, pad) from
        its output sites ``x`` back onto its input sites ``fine``: fine[f]
        += x[o] @ w[k] wherever f = o * stride - pad + k."""
        w = self.rnd(w)
        f = self.rnd(x.feats)
        dev = f.device
        acc = torch.zeros((len(fine), w.shape[-1]), dtype=torch.float32,
                          device=dev)
        pairs = []
        st = torch.tensor(stride, dtype=torch.int64, device=dev)
        for k, kv in enumerate(_kernel_positions(kernel)):
            num = fine.coords + torch.tensor(pad, device=dev) - torch.tensor(
                kv, device=dev)
            ok = (num % st == 0).all(dim=1)
            idx = x.sites.find(torch.div(num, st, rounding_mode="floor"))
            idx = torch.where(ok, idx, -1)
            o = torch.nonzero(idx >= 0)[:, 0]
            i = idx[o]
            if o.numel():
                acc[o] += f[i] @ w[k]
            if self.tape is not None:
                pairs.append((i, o))
        return self._out(fine, acc, "conv", [x], pairs=pairs,
                         cin=w.shape[1], cout=w.shape[2], span=False,
                         name=name)

    def linear(self, x: T, w, b=None, name=""):
        y = self.rnd(x.feats) @ self.rnd(w)
        if b is not None:
            y = y + b
        n = len(x.sites)
        idx = torch.arange(n, device=y.device)
        return self._out(x.sites, y, "conv", [x], pairs=[(idx, idx)],
                         cin=w.shape[0], cout=w.shape[1], span=False,
                         name=name)

    # -- pointwise
    def bn(self, x: T, name: str, eps: float):
        sd = self.sd
        y = ((x.feats - sd[f"{name}.mean"]) * torch.rsqrt(sd[f"{name}.var"] + eps)
             * sd[f"{name}.scale"] + sd[f"{name}.bias"])
        return self._out(x.sites, y, "pw", [x])

    def relu(self, x: T):
        return self._out(x.sites, torch.clamp_min(x.feats, 0.0), "pw", [x])

    def add(self, a: T, b: T):
        return self._out(a.sites, a.feats + b.feats, "pw", [a, b])

    def cat(self, a: T, b: T):
        return self._out(a.sites, torch.cat([a.feats, b.feats], dim=1), "pw",
                         [a, b])

    def gather(self, x: T, out: Sites, rows: torch.Tensor):
        """out row r takes x's row rows[r] (zeros where -1)."""
        pad = torch.cat([x.feats, x.feats.new_zeros((1, x.feats.shape[1]))])
        y = pad[torch.where(rows >= 0, rows, len(x.sites))]
        return self._out(out, y, "gather", [x], rows=rows)


def _kernel_positions(kernel):
    """Kernel positions in weight order: x fastest, then y, z, t."""
    rng = [range(k) for k in kernel]
    out = []
    for rest in _product(rng[1:]):
        for ix in rng[0]:
            out.append((ix,) + rest)
    return out


def _product(ranges):
    if not ranges:
        return [()]
    out = []
    for last in ranges[-1]:
        for head in _product(ranges[:-1]):
            out.append(head + (last,))
    return out


def taps(kernel, offset) -> torch.Tensor:
    """(K, D) input offsets of each kernel position (weight order):
    position minus ``offset`` per dim."""
    return torch.tensor([[p - o for p, o in zip(pos, offset)]
                         for pos in _kernel_positions(kernel)],
                        dtype=torch.int64)


def subm_taps(kernel):
    return taps(kernel, [(k - 1) // 2 for k in kernel])


# --------------------------------------------------------------- MotionNet
_MEPS = 1e-5  # MinkowskiEngine's BatchNorm eps (MotionNet)
_UEPS = 1e-3  # spconv's (UNet, BEV backbone)


def conv_bn_relu(net, x, out, name, kernel_taps, stride, eps, span=True):
    y = net.conv(x, out, net.sd[f"{name}.conv.w"], kernel_taps, stride,
                 span=span, name=name)
    return net.relu(net.bn(y, f"{name}.bn", eps))


def basic_block(net, x, name, kernel_taps, eps, stride):
    y = net.conv(x, x.sites, net.sd[f"{name}.conv1.w"], kernel_taps, stride,
                 name=f"{name}.conv1")
    y = net.relu(net.bn(y, f"{name}.bn1", eps))
    y = net.conv(y, x.sites, net.sd[f"{name}.conv2.w"], kernel_taps, stride,
                 name=f"{name}.conv2")
    y = net.bn(y, f"{name}.bn2", eps)
    if f"{name}.down.w" in net.sd:
        idt = net.linear(x, net.sd[f"{name}.down.w"][0], name=f"{name}.down")
        idt = net.bn(idt, f"{name}.down_bn", eps)
    else:
        idt = x
    return net.relu(net.add(y, idt))


def strided_sites(s: Sites, kernel, stride, pad, out_dims) -> Sites:
    """Output sites of a strided conv: every o inside ``out_dims`` with
    o * stride - pad + k a site for some kernel position k."""
    dev = s.coords.device
    outs = []
    st = torch.tensor(stride, dtype=torch.int64, device=dev)
    for kv in _kernel_positions(kernel):
        num = s.coords + torch.tensor(pad, device=dev) - torch.tensor(
            kv, device=dev)
        ok = (num % st == 0).all(dim=1)
        outs.append(torch.div(num[ok], st, rounding_mode="floor"))
    return Sites.unique(torch.cat(outs), out_dims)


def motionnet(net: Net, cfg: dict, s1: Sites, stem: T, cur_rows):
    """MotionNet from its level-1 sites and stem output to the logits of
    the current scan's points (``cur_rows``: each point's level-1 site row,
    -1 outside the grid)."""
    K2, K3 = (2, 2, 2, 1), (3, 3, 3, 3)
    down_taps = taps(K2, (0, 0, 0, 0))
    blk_taps = subm_taps(K3)
    one = (1, 1, 1, 1)
    S2 = (2, 2, 2, 1)
    dims = {1: s1.dims}
    sites = {1: s1}
    for f in (2, 4, 8):
        d = tuple(-(-g // f) for g in s1.dims[:3]) + (s1.dims[3],)
        dims[f] = d
        sites[f] = strided_sites(sites[f // 2], K2, S2, (0, 0, 0, 0), d)
    y = conv_bn_relu(net, stem, sites[2], "motion.down1", down_taps, S2, _MEPS)
    b1 = basic_block(net, y, "motion.block1", blk_taps, _MEPS, one)
    y = conv_bn_relu(net, b1, sites[4], "motion.down2", down_taps, S2, _MEPS)
    b2 = basic_block(net, y, "motion.block2", blk_taps, _MEPS, one)
    y = conv_bn_relu(net, b2, sites[8], "motion.down3", down_taps, S2, _MEPS)
    y = basic_block(net, y, "motion.block3", blk_taps, _MEPS, one)
    for up, blk, lat in (("up5", "block6", b2), ("up6", "block7", b1),
                         ("up7", "block8", stem)):
        u = net.inverse(y, lat.sites, net.sd[f"motion.{up}.conv.w"], K2, S2,
                        (0, 0, 0, 0), name=f"motion.{up}")
        u = net.relu(net.bn(u, f"motion.{up}.bn", _MEPS))
        y = basic_block(net, net.cat(u, lat), f"motion.{blk}", blk_taps,
                        _MEPS, one)
    logits = net.linear(y, net.sd["motion.final.w"], net.sd["motion.final.b"],
                        name="motion.final")
    return net.gather(logits, Points(cur_rows.shape[0], cur_rows.device),
                      cur_rows)


def stem3d(net: Net, sites: Sites) -> torch.Tensor:
    """The stem (subm (5,5,5), BN, ReLU) of one scan on its own 3D sites,
    unrecorded (a fixed-frame scan's stem from an earlier step)."""
    tape, net.tape = net.tape, None
    try:
        x = T(sites, torch.full((len(sites), 1), 0.5, device=sites.keys.device))
        return conv_bn_relu(net, x, sites, "motion.stem",
                            subm_taps((5, 5, 5)), (1, 1, 1), _MEPS).feats
    finally:
        net.tape = tape


# ----------------------------------------------------------------- windows
def voxel_coords(xyz, lo, scale):
    """floor((xyz - lo) * scale) as int64, with the float32 arithmetic of
    the modes' definitions."""
    return torch.floor((xyz - lo) * scale).to(torch.int64)


def refexact_window(cfg: dict, scans, tfs, device):
    """The stored window after the last step, as the ref-exact mode keeps
    it: (points (W, P, 4) float32, counts (W,)). ``scans``/``tfs``: the
    last W steps' scans and transforms, oldest first, None before the
    stream's start."""
    W = cfg["model"]["n_past_steps"]
    P = cfg["runtime"]["max_points_per_scan"]
    pts = torch.zeros((W, P, 4), dtype=torch.float32, device=device)
    num = [0] * W
    for scan, tf in zip(scans, tfs):
        if scan is None:
            continue
        tf = torch.from_numpy(np.asarray(tf, np.float32)).to(device)
        pts = torch.roll(pts, -1, dims=0)
        xyz = pts[..., :3] @ tf[:3, :3].T + tf[:3, 3]
        pts = torch.cat([xyz, pts[..., 3:]], dim=-1)
        pts[W - 1] = 0.0
        pts[W - 1, :len(scan)] = torch.from_numpy(scan[:, :4]).to(device)
        num = num[1:] + [len(scan)]
    return pts, num


def motion_inputs_refexact(net, cfg, scans, tfs, device):
    """(level-1 4D sites, stem output, current points' site rows, current
    scan (n, 4)) of a ref-exact step."""
    mc = cfg["model"]["motionnet"]
    W = cfg["model"]["n_past_steps"]
    pts, num = refexact_window(cfg, scans, tfs, device)
    lo = torch.tensor(mc["crop_range"][:3], dtype=torch.float32, device=device)
    dims3 = _mdims(mc)
    coords, cur = [], None
    for t in range(W):
        if num[t] == 0:
            continue
        c3 = voxel_coords(pts[t, :num[t], :3], lo, 10.0)
        c4 = torch.cat([c3, torch.full_like(c3[:, :1], t)], dim=1)
        coords.append(c4)
        if t == W - 1:
            cur = c4
    s1 = Sites.unique(torch.cat(coords), dims3 + (W,))
    x = T(s1, torch.full((len(s1), 1), 0.5, device=device))
    x.tid = net.tape.new(len(s1)) if net.tape is not None else 0
    stem = conv_bn_relu(net, x, s1, "motion.stem", subm_taps((5, 5, 5, 1)),
                        (1, 1, 1, 1), _MEPS)
    return s1, stem, s1.find(cur), pts[W - 1, :num[W - 1]]


def motion_inputs_fixedframe(net, cfg, scans, tfs, device):
    """The same for a fixed-frame step: each scan's arrival sites moved by
    the later steps' integer-voxel translations, kept while inside the
    grid; each scan's stem from its arrival."""
    mc = cfg["model"]["motionnet"]
    W = cfg["model"]["n_past_steps"]
    vox = cfg["data"]["voxel_size"][0]
    lo = torch.tensor(mc["crop_range"][:3], dtype=torch.float32, device=device)
    dims3 = _mdims(mc)
    k = [None if tf is None else
         torch.from_numpy(np.round(np.asarray(tf, np.float32)[:3, 3] / vox)
                          .astype(np.int64)).to(device) for tf in tfs]
    coords, feats = [], []
    cur = None
    for t, scan in enumerate(scans):
        if scan is None:
            continue
        xyz = torch.from_numpy(scan[:, :3]).to(device)
        c3 = voxel_coords(xyz, lo, 10.0)
        arr = Sites.unique(c3, dims3)
        if t == W - 1:
            sx = T(arr, torch.full((len(arr), 1), 0.5, device=device))
            sx.tid = net.tape.new(len(arr)) if net.tape is not None else 0
            st = conv_bn_relu(net, sx, arr, "motion.stem",
                              subm_taps((5, 5, 5)), (1, 1, 1), _MEPS)
            stem_t = st
            cur = c3
        else:
            stem_t = T(arr, stem3d(net, arr))
        c, keep = arr.coords, torch.ones(len(arr), dtype=torch.bool,
                                         device=device)
        for u in range(t + 1, W):
            c = c + k[u]
            keep = keep & _inside(c, dims3)
        coords.append((t, c[keep], stem_t, torch.nonzero(keep)[:, 0]))
    c4 = torch.cat([torch.cat([c, torch.full_like(c[:, :1], t)], dim=1)
                    for t, c, _, _ in coords])
    s1 = Sites(c4, dims3 + (W,))
    # every (site, slot) is one scan's arrival site: the stem rows gather
    parts = []
    for t, c, stem_t, src in coords:
        rows = s1.find(torch.cat([c, torch.full_like(c[:, :1], t)], dim=1))
        parts.append((rows, stem_t, src))
    stem = _assemble(net, s1, parts)
    cur4 = torch.cat([cur, torch.full_like(cur[:, :1], W - 1)], dim=1)
    return s1, stem, s1.find(cur4), torch.from_numpy(
        scans[W - 1][:, :4]).to(device)


def _assemble(net, s1, parts):
    """Stem rows of every slot gathered onto the window's sites."""
    C = parts[0][1].feats.shape[1]
    out = torch.zeros((len(s1), C), dtype=torch.float32, device=s1.keys.device)
    for rows, stem_t, src in parts:
        out[rows] = stem_t.feats[src]
    ins = [p[1] for p in parts if p[1].tid]
    t = T(s1, out)
    if net.tape is not None:
        t.tid = net.tape.new(len(s1))
        new = parts[-1]
        rows_all = torch.full((len(s1),), -1, dtype=torch.int64,
                              device=out.device)
        rows_all[new[0]] = new[2]
        net.tape.ops.append(dict(kind="gather", out=t.tid,
                                 ins=[p.tid for p in ins], rows=rows_all))
    return t


def _mdims(mc):
    r = mc["crop_range"]
    return tuple(int(round((r[i + 3] - r[i]) / 0.1)) for i in range(3))


# ------------------------------------------------------------------- tail
def voxelize(cfg, pts: torch.Tensor, motion: torch.Tensor):
    """The current scan's voxels: (sites, (V, 7) mean features, each
    point's voxel row or -1). Mean over a voxel's first
    ``max_points_per_voxel`` points in point order."""
    d = cfg["data"]
    dev = pts.device
    inv = 1.0 / torch.tensor(d["voxel_size"], dtype=torch.float32, device=dev)
    lo = torch.tensor(d["point_cloud_range"][:3], dtype=torch.float32,
                      device=dev)
    dims = _grid(d)
    c = voxel_coords(pts[:, :3], lo, inv)
    sites = Sites.unique(c, dims)
    row = sites.find(c)
    feats = torch.cat([pts[:, :4], motion], dim=1)
    M = cfg["model"]["max_points_per_voxel"]
    order = torch.sort(torch.where(row >= 0, row, len(sites)), stable=True)
    srow = order.values
    first = torch.searchsorted(srow, srow, side="left")
    rank = torch.arange(len(srow), device=dev) - first
    rank_pt = torch.empty_like(rank)
    rank_pt[order.indices] = rank
    acc = torch.zeros((len(sites), feats.shape[1]), dtype=torch.float32,
                      device=dev)
    for s in range(M):
        sel = (row >= 0) & (rank_pt == s)
        acc[row[sel]] = acc[row[sel]] + feats[sel]
    cnt = torch.zeros(len(sites), dtype=torch.int64, device=dev)
    cnt.index_add_(0, row[row >= 0], torch.ones_like(row[row >= 0]))
    den = torch.clamp(torch.clamp(cnt, max=M), min=1).to(torch.float32)
    return sites, acc / den[:, None], row, torch.where(rank_pt < M, row, -1)


def _grid(d):
    r, v = d["point_cloud_range"], d["voxel_size"]
    return tuple(int(round((r[i + 3] - r[i]) / v[i])) for i in range(3))


def box_class_features(coords, boxes, labels, nc, lo, vs, stride):
    """(N, nc) {0, 1}: a site lies in a kept box of that class, the box in
    the level's grid units (centre (b - lo) / (vs * stride)), the site at
    its integer coordinates."""
    if boxes.shape[0] == 0:
        return torch.zeros((coords.shape[0], nc), device=coords.device)
    g = vs * stride
    ctr = (boxes[:, 0:3] - lo[None]) / g[None]
    size = boxes[:, 3:6] / g[None]
    p = coords.to(torch.float32)
    d = p[:, None, :] - ctr[None]
    cos, sin = torch.cos(boxes[:, 6])[None], torch.sin(boxes[:, 6])[None]
    rx = d[..., 0] * cos + d[..., 1] * sin
    ry = -d[..., 0] * sin + d[..., 1] * cos
    half = size[None] * 0.5
    inside = ((rx.abs() <= half[..., 0]) & (ry.abs() <= half[..., 1])
              & (d[..., 2].abs() <= half[..., 2]))
    onehot = (labels[:, None].to(torch.int64) - 1
              == torch.arange(nc, device=coords.device)[None]).to(torch.float32)
    return torch.clamp(inside.to(torch.float32) @ onehot, max=1.0)


def conv2d_same(net, x, w, stride):
    """NCHW conv with TF-style SAME padding."""
    kh, kw = w.shape[2], w.shape[3]
    pads = []
    for size, k in ((x.shape[3], kw), (x.shape[2], kh)):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(net.rnd(x), pads), net.rnd(w), stride=stride)


def bn2d(net, x, name, eps):
    sd = net.sd
    sh = (1, -1, 1, 1)
    return ((x - sd[f"{name}.mean"].view(sh))
            * torch.rsqrt(sd[f"{name}.var"].view(sh) + eps)
            * sd[f"{name}.scale"].view(sh) + sd[f"{name}.bias"].view(sh))


def detect(net, cfg, bev):
    """Dense BEV (Y, X, C) -> kept (boxes (k, 7), scores, labels) and the
    dense work in FLOPs."""
    m = cfg["model"]
    b = m["bev"]
    x = bev.permute(2, 0, 1)[None]
    flops = 0
    ups = []
    for lvl in range(len(b["layer_nums"])):
        for k in range(b["layer_nums"][lvl] + 1):
            w = net.sd[f"bev.blocks.{lvl}.convs.{k}.w"]
            x = conv2d_same(net, x, w, b["layer_strides"][lvl] if k == 0 else 1)
            flops += 2 * x.shape[2] * x.shape[3] * w.numel()
            x = torch.clamp_min(bn2d(net, x, f"bev.blocks.{lvl}.bns.{k}",
                                     _UEPS), 0.0)
        w = net.sd[f"bev.deblocks.{lvl}.conv.w"]
        s = b["upsample_strides"][lvl]
        u = F.conv_transpose2d(net.rnd(x), net.rnd(w), stride=s)
        flops += 2 * x.shape[2] * x.shape[3] * w.numel()
        ups.append(torch.clamp_min(bn2d(net, u, f"bev.deblocks.{lvl}.bn",
                                        _UEPS), 0.0))
    feat = torch.cat(ups, dim=1)[0].permute(1, 2, 0)
    H, Wd, C = feat.shape
    f = net.rnd(feat.reshape(-1, C))
    cls = f @ net.rnd(net.sd["head.cls.w"][0, 0]) + net.sd["head.cls.b"]
    box = f @ net.rnd(net.sd["head.box.w"][0, 0]) + net.sd["head.box.b"]
    flops += 2 * H * Wd * C * (cls.shape[1] + box.shape[1])
    d, pp = cfg["data"], m["post"]
    osf = m["head"]["out_size_factor"]
    ys, xs = torch.meshgrid(torch.arange(H, device=f.device),
                            torch.arange(Wd, device=f.device), indexing="ij")
    cx = (xs.reshape(-1) + box[:, 0]) * osf * d["voxel_size"][0] + \
        d["point_cloud_range"][0]
    cy = (ys.reshape(-1) + box[:, 1]) * osf * d["voxel_size"][1] + \
        d["point_cloud_range"][1]
    boxes = torch.cat([torch.stack([cx, cy, box[:, 2]], -1),
                       torch.exp(box[:, 3:6]),
                       torch.atan2(box[:, 6], box[:, 7])[:, None]], dim=-1)
    scores, labels = torch.sigmoid(cls).max(dim=-1)
    cand = torch.nonzero(scores >= pp["score_thresh"])[:, 0]
    order = torch.sort(scores[cand], descending=True, stable=True).indices
    cand = cand[order][:pp["nms_pre_maxsize"]]
    bx = boxes[cand].double().cpu().numpy()
    keep = greedy_rotated_nms(bx, pp["nms_thresh"], pp["nms_post_maxsize"])
    sel = cand[torch.as_tensor(keep, dtype=torch.int64, device=f.device)]
    return boxes[sel], scores[sel], (labels[sel] + 1).to(torch.int32), flops


def unet_tail(net: Net, cfg: dict, pts: torch.Tensor, motion: T):
    """Voxelizer, UNet with detection and fusion, MOS head, devoxelize."""
    m, d = cfg["model"], cfg["data"]
    dev = pts.device
    nc = m["head"]["num_class"]
    sites1, vfeat, prow, in_mean = voxelize(cfg, pts, motion.feats)
    g = sites1.dims
    dims = {s: tuple(-(-x // s) for x in g) for s in (1, 2, 4, 8)}
    K3, S2, P1 = (3, 3, 3), (2, 2, 2), (1, 1, 1)
    sub = subm_taps(K3)
    dn = taps(K3, P1)
    one = (1, 1, 1)
    lv = {1: sites1}
    for s in (2, 4, 8):
        lv[s] = strided_sites(lv[s // 2], K3, S2, P1, dims[s])
    x = net._out(sites1, vfeat, "scatter", [motion], rows=in_mean)
    y = conv_bn_relu(net, x, sites1, "unet.conv_input", sub, one, _UEPS)
    y = conv_bn_relu(net, y, sites1, "unet.conv1", sub, one, _UEPS)
    enc = {1: y}
    for lvl, s in ((2, 2), (3, 4), (4, 8)):
        y = conv_bn_relu(net, y, lv[s], f"unet.conv{lvl}_down", dn, S2, _UEPS)
        y = conv_bn_relu(net, y, lv[s], f"unet.conv{lvl}_a", sub, one, _UEPS)
        y = conv_bn_relu(net, y, lv[s], f"unet.conv{lvl}_b", sub, one, _UEPS)
        enc[s] = y
    KZ, SZ = (1, 1, 3), (1, 1, 2)
    d8 = dims[8]
    d_out = (d8[0], d8[1], (d8[2] - 3) // 2 + 1)
    s_out = strided_sites(lv[8], KZ, SZ, (0, 0, 0), d_out)
    encoded = conv_bn_relu(net, y, s_out, "unet.conv_out", taps(KZ, (0, 0, 0)),
                           SZ, _UEPS)

    X, Y, Z = d_out
    C = encoded.feats.shape[1]
    c = encoded.sites.coords
    dense = torch.zeros((Y * X * Z, C), dtype=torch.float32, device=dev)
    dense[(c[:, 1] * X + c[:, 0]) * Z + c[:, 2]] = encoded.feats
    bev = dense.reshape(Y, X, Z, C).permute(0, 1, 3, 2).reshape(Y, X, C * Z)
    boxes, scores, labels, dense_flops = detect(net, cfg, bev)

    y = net.inverse(encoded, lv[8], net.sd["unet.inv_conv_out.conv.w"], KZ,
                    SZ, (0, 0, 0), name="unet.inv_conv_out")
    vs = torch.tensor(d["voxel_size"], dtype=torch.float32, device=dev)
    lo = torch.tensor(d["point_cloud_range"][:3], dtype=torch.float32,
                      device=dev)

    def fuse(t: T, stride, name):
        inst = box_class_features(t.sites.coords, boxes, labels, nc, lo, vs,
                                  stride)
        it = net._out(t.sites, inst, "pw", [])
        return conv_bn_relu(net, net.cat(t, it), t.sites, name, sub, one,
                            _UEPS), it

    def ur(lat, bot, names, fine, last=False):
        t_name, m_name, inv_name = names
        xt = basic_block(net, lat, t_name, sub, _UEPS, one)
        cat = net.cat(bot, xt)
        xm = conv_bn_relu(net, cat, lat.sites, m_name, sub, one, _UEPS)
        n, c2 = cat.feats.shape
        red = net._out(cat.sites, cat.feats.reshape(n, c2 // 2, 2).sum(2),
                       "pw", [cat])
        fused = net.add(xm, red)
        if last:
            return conv_bn_relu(net, fused, fused.sites, inv_name, sub, one,
                                _UEPS)
        u = net.inverse(fused, fine, net.sd[f"{inv_name}.conv.w"], K3, S2,
                        P1, name=inv_name)
        return net.relu(net.bn(u, f"{inv_name}.bn", _UEPS))

    y, _ = fuse(y, 8, "unet.fuse4")
    y = ur(y, y, ("unet.up_t4", "unet.up_m4", "unet.inv4"), lv[4])
    y, _ = fuse(y, 4, "unet.fuse3")
    y = ur(enc[4], y, ("unet.up_t3", "unet.up_m3", "unet.inv3"), lv[2])
    y, _ = fuse(y, 2, "unet.fuse2")
    y = ur(enc[2], y, ("unet.up_t2", "unet.up_m2", "unet.inv2"), lv[1])
    y, inst1 = fuse(y, 1, "unet.fuse1")
    y = ur(enc[1], y, ("unet.up_t1", "unet.up_m1", "unet.up_out"), None,
           last=True)
    y = conv_bn_relu(net, net.cat(y, inst1), sites1, "unet.fuse1_final", sub,
                     one, _UEPS)
    logits = net.linear(y, net.sd["unet.mos_head.w"], net.sd["unet.mos_head.b"],
                        name="unet.mos_head")
    out = net.gather(logits, Points(prow.shape[0], dev), prow)
    if net.tape is not None:
        net.tape.roots = [out.tid, encoded.tid]
    return out, boxes, scores, labels, dense_flops


def step(cfg: dict, sd: dict, scans, tfs, *, fixed_frame: bool,
         dtype: str = "float32", tape: Tape | None = None, device="cpu"):
    """One streaming step's outputs from the last W steps' scans and
    transforms (oldest first, None before the stream's start): per-point
    MOS logits (n, 3), kept boxes (k, 7), scores (k,), labels (k,) as
    numpy, and the dense layers' FLOPs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = Net(sd, dtype, tape)
    with torch.no_grad():
        build = motion_inputs_fixedframe if fixed_frame else \
            motion_inputs_refexact
        s1, stem, cur_rows, cur_pts = build(net, cfg, scans, tfs, device)
        motion = motionnet(net, cfg, s1, stem, cur_rows)
        logits, boxes, scores, labels, dense = unet_tail(net, cfg, cur_pts,
                                                         motion)
    return dict(point_logits=logits.feats.cpu().numpy(),
                boxes=boxes.cpu().numpy(), scores=scores.cpu().numpy(),
                labels=labels.cpu().numpy(), dense_flops=dense)

