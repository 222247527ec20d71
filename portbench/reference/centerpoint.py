"""Plain reference of one CenterPoint streaming step (voxel 0.075 m,
nuScenes, 10 sweeps), in PyTorch, for the benchmark's check of the timed
path's boxes.

It imports nothing of the program. It takes the same sweeps, transforms
and weights (a state dict in OpenPCDet's layout, block conv biases
explicit) and works out everything again: the sweep window, the merged
cloud, the voxels, every site set, every conv's pairs, the dense maps, the
boxes. Sparse convs are exact rulebook convs over coordinate sets
(``reference/model.py``'s ``Sites`` and ``Net``): no capacities and no
span plans. A step on which the program dropped a voxel or a site, or
left a conv row uncovered, is not compared, so the reference needs none
of those limits. Matmul operands are rounded to ``dtype`` and multiplied
in float32 with TF32 off; NMS runs in float64.

The step, as OpenPCDet runs ``cbgs_voxel0075_res3d_centerpoint.yaml`` at
test time:

- the last W sweeps (W = ``sweeps.n_sweeps``), each rolled into the newest
  sweep's frame by the step transforms in float32 (the stored points carry
  every earlier transform); a sweep's points with |x| and |y| under
  ``ego_radius`` in its own frame are removed from it once it is older
  than the newest (``remove_ego_points``);
- one cloud of (x, y, z, intensity, lag), lag = ``sweep_dt`` x the
  sweep's age, cropped to the voxel grid;
- MeanVFE: 0.075 x 0.075 x 0.2 m voxels, each the mean of its first
  ``max_points_per_voxel`` points in the cloud's order;
- VoxelResBackBone8x (BN eps 1e-3), HeightCompression, the BEV backbone
  (BN eps 1e-3), the shared conv and the six groups of separate heads (BN
  eps 1e-5), all BN in eval mode;
- per group: sigmoid, the top ``max_obj_per_group`` over (class, cell),
  the box decode, the score gate and the centre limit, class-agnostic
  rotated BEV NMS (IoU ``nms_thresh``, ``nms_pre_maxsize`` in,
  ``nms_post_maxsize`` out); labels 1-10 in ``CLASS_NAMES`` order.

Departures from OpenPCDet, which the program shares:

- the sweeps merge in a fixed order, the newest first and then by age
  (OpenPCDet draws the 9 older sweeps in a random order), so that a step
  is deterministic;
- the lag is exactly ``sweep_dt`` a sweep (nuScenes' timestamps jitter);
- BN runs in eval mode on the benchmark's weights: a seeded recipe with
  the dense half's BN shifts raised by 1, BN statistics calibrated on one
  window of the benchmark's own traffic, regression heads scaled to a
  trained head's spreads and a calibrated heatmap head
  (``portbench/cp_weights.py``), not a trained checkpoint;
- the BEV backbone's stride-2 conv pads as TF's SAME (0 before, 1 after)
  where OpenPCDet's ``ZeroPad2d(1)`` pads 1 on both sides;
- ties in the top-K and in NMS go by index (``torch.topk`` leaves them
  unspecified).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .model import (T, Net, Sites, Tape, conv2d_same, strided_sites, subm_taps,
                    taps, voxel_coords)
from .nms import greedy_rotated_nms

CLASS_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")
_BEPS = 1e-3  # the sparse backbone's and the BEV backbone's BN eps
K3, S2, P1, P4 = (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 0)
KZ, SZ, PZ = (1, 1, 3), (1, 1, 2), (0, 0, 0)
ONE = (1, 1, 1)


# ------------------------------------------------------------------ sweeps
def sweep_window(cd: dict, scans, tfs, device):
    """The ring after the last step: (points (W, P, 4) float32 in the
    newest frame, oldest first; counts [W]; ego-box flags (W, P), each
    from its sweep's own frame)."""
    W = cd["sweeps"]["n_sweeps"]
    P = cd["runtime"]["max_points_per_scan"]
    r = cd["sweeps"]["ego_radius"]
    pts = torch.zeros((W, P, 4), dtype=torch.float32, device=device)
    near = torch.zeros((W, P), dtype=torch.bool, device=device)
    num = [0] * W
    for scan, tf in zip(scans, tfs):
        if scan is None:
            continue
        tf = torch.from_numpy(np.asarray(tf, np.float32)).to(device)
        pts = torch.roll(pts, -1, dims=0)
        xyz = pts[..., :3] @ tf[:3, :3].T + tf[:3, 3]
        pts = torch.cat([xyz, pts[..., 3:]], dim=-1)
        new = torch.zeros((P, 4), dtype=torch.float32, device=device)
        new[:len(scan)] = torch.from_numpy(np.asarray(scan[:, :4],
                                                      np.float32)).to(device)
        pts[W - 1] = new
        near = torch.roll(near, -1, dims=0)
        near[W - 1] = (new[:, 0].abs() < r) & (new[:, 1].abs() < r)
        num = num[1:] + [len(scan)]
    return pts, num, near


def merged_cloud(cd: dict, pts, num, near):
    """(N, 5) x, y, z, intensity, lag: the newest sweep first, then by
    age, older sweeps without their ego-box points."""
    W = pts.shape[0]
    lag = torch.arange(W, device=pts.device).to(torch.float32) * \
        cd["sweeps"]["sweep_dt"]
    parts = []
    for age in range(W):
        t = W - 1 - age
        keep = torch.arange(pts.shape[1], device=pts.device) < num[t]
        if age > 0:
            keep = keep & ~near[t]
        p = pts[t][keep]
        parts.append(torch.cat([p, lag[age].expand(len(p), 1)], dim=1))
    return torch.cat(parts)


def grid_size(cd: dict):
    d = cd["data"]
    r, v = d["point_cloud_range"], d["voxel_size"]
    return tuple(int(round((r[i + 3] - r[i]) / v[i])) for i in range(3))


def voxelize(cd: dict, cloud):
    """(sites over the sparse shape, (V, 5) means of each voxel's first
    ``max_points_per_voxel`` points in cloud order, points in range)."""
    d = cd["data"]
    dev = cloud.device
    inv = 1.0 / torch.tensor(d["voxel_size"], dtype=torch.float32, device=dev)
    lo = torch.tensor(d["point_cloud_range"][:3], dtype=torch.float32,
                      device=dev)
    g = grid_size(cd)
    c = voxel_coords(cloud[:, :3], lo, inv)
    inside = ((c >= 0) & (c < torch.tensor(g, device=dev))).all(dim=1)
    c, f = c[inside], cloud[inside]
    sites = Sites.unique(c, g[:2] + (g[2] + 1,))
    row = sites.find(c)
    M = cd["model"]["backbone"]["max_points_per_voxel"]
    order = torch.sort(row, stable=True)
    first = torch.searchsorted(order.values, order.values, side="left")
    rank = torch.empty_like(row)
    rank[order.indices] = torch.arange(len(row), device=dev) - first
    acc = torch.zeros((len(sites), 5), dtype=torch.float32, device=dev)
    for s in range(M):
        sel = rank == s
        acc[row[sel]] = acc[row[sel]] + f[sel]
    cnt = torch.bincount(row, minlength=len(sites))
    den = torch.clamp(torch.clamp(cnt, max=M), min=1).to(torch.float32)
    return sites, acc / den[:, None], int(inside.sum())


# ----------------------------------------------------------- sparse layers
def _bn(net: Net, x: T, name: str, eps: float, calib):
    """Eval-mode BN over the last axis; with ``calib`` (a dict) the rows'
    own mean and biased variance, recorded under ``name``."""
    f = x.feats
    sd = net.sd
    if calib is not None:
        mean, var = f.mean(dim=0), f.var(dim=0, unbiased=False)
        calib[name] = (mean, var)
    else:
        mean, var = sd[f"{name}.mean"], sd[f"{name}.var"]
    y = (f - mean) * torch.rsqrt(var + eps) * sd[f"{name}.scale"] + \
        sd[f"{name}.bias"]
    return net._out(x.sites, y, "pw", [x])


def _conv_bn_relu(net, x, out, name, kt, stride, calib):
    y = net.conv(x, out, net.sd[f"{name}.conv.w"], kt, stride, name=name)
    return net.relu(_bn(net, y, f"{name}.bn", _BEPS, calib))


def _res_block(net, x, name, calib):
    """OpenPCDet's SparseBasicBlock: subm convs with bias."""
    sd, sub = net.sd, subm_taps(K3)
    y = net.conv(x, x.sites, sd[f"{name}.conv1.w"], sub, ONE,
                 name=f"{name}.conv1")
    y = net._out(y.sites, y.feats + sd[f"{name}.conv1.b"], "pw", [y])
    y = net.relu(_bn(net, y, f"{name}.bn1", _BEPS, calib))
    y = net.conv(y, x.sites, sd[f"{name}.conv2.w"], sub, ONE,
                 name=f"{name}.conv2")
    y = net._out(y.sites, y.feats + sd[f"{name}.conv2.b"], "pw", [y])
    y = _bn(net, y, f"{name}.bn2", _BEPS, calib)
    return net.relu(net.add(y, x))


def backbone3d(net: Net, cd: dict, x: T, calib=None) -> T:
    """VoxelResBackBone8x from the voxels to conv_out's output."""
    nb = 2
    geo = {2: (K3, S2, P1), 4: (K3, S2, P1), 8: (K3, S2, P4),
           "out": (KZ, SZ, PZ)}
    sites = {1: x.sites}
    for fin, s in ((1, 2), (2, 4), (4, 8), (8, "out")):
        k, st, pd = geo[s]
        d = sites[fin].dims
        out = tuple((d[i] + 2 * pd[i] - k[i]) // st[i] + 1 for i in range(3))
        sites[s] = strided_sites(sites[fin], k, st, pd, out)
    p = "backbone3d"
    y = _conv_bn_relu(net, x, sites[1], f"{p}.conv_input", subm_taps(K3), ONE,
                      calib)
    for lvl, s in ((1, 1), (2, 2), (3, 4), (4, 8)):
        if lvl > 1:
            k, st, pd = geo[s]
            y = _conv_bn_relu(net, y, sites[s], f"{p}.conv{lvl}_down",
                              taps(k, pd), st, calib)
        for b in range(nb):
            y = _res_block(net, y, f"{p}.conv{lvl}.{b}", calib)
    k, st, pd = geo["out"]
    return _conv_bn_relu(net, y, sites["out"], f"{p}.conv_out", taps(k, pd),
                         st, calib)


# ------------------------------------------------------------------- dense
def _bn2d(net, x, name, eps, calib):
    sd = net.sd
    sh = (1, -1, 1, 1)
    if calib is not None:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        calib[name] = (mean, var)
    else:
        mean, var = sd[f"{name}.mean"], sd[f"{name}.var"]
    return ((x - mean.view(sh)) * torch.rsqrt(var.view(sh) + eps)
            * sd[f"{name}.scale"].view(sh) + sd[f"{name}.bias"].view(sh))


def height_compression(enc: T):
    """(Y, X, C * Z) with channel c * Z + z (spconv's dense().view)."""
    X, Y, Z = enc.sites.dims
    C = enc.feats.shape[1]
    c = enc.sites.coords
    dense = torch.zeros((Y * X * Z, C), dtype=torch.float32,
                        device=enc.feats.device)
    dense[(c[:, 1] * X + c[:, 0]) * Z + c[:, 2]] = enc.feats
    return dense.reshape(Y, X, Z, C).permute(0, 1, 3, 2).reshape(Y, X, C * Z)


def dense_part(net: Net, cd: dict, bev, calib=None):
    """The BEV backbone, the shared conv and every group's heads. Returns
    (per group {head: (c, H, W)}, FLOPs)."""
    m = cd["model"]
    b = m["bev"]
    sd = net.sd
    x = bev.permute(2, 0, 1)[None]
    flops = 0
    ups = []
    for lvl in range(len(b["layer_nums"])):
        for k in range(b["layer_nums"][lvl] + 1):
            w = sd[f"bev.blocks.{lvl}.convs.{k}.w"]
            stride = b["layer_strides"][lvl] if k == 0 else 1
            x = conv2d_same(net, x, w, stride)
            flops += 2 * x.shape[2] * x.shape[3] * w.numel()
            x = torch.clamp_min(_bn2d(net, x, f"bev.blocks.{lvl}.bns.{k}",
                                      _BEPS, calib), 0.0)
        w = sd[f"bev.deblocks.{lvl}.conv.w"]
        s = b["upsample_strides"][lvl]
        u = F.conv_transpose2d(net.rnd(x), net.rnd(w), stride=s)
        flops += 2 * x.shape[2] * x.shape[3] * w.numel()
        ups.append(torch.clamp_min(_bn2d(net, u, f"bev.deblocks.{lvl}.bn",
                                         _BEPS, calib), 0.0))
    x = torch.cat(ups, dim=1)
    eps = m["head"]["bn_eps"]

    def conv(x, name):
        nonlocal flops
        w = sd[f"{name}.w"]
        y = conv2d_same(net, x, w, 1) + sd[f"{name}.b"].view(1, -1, 1, 1)
        flops += 2 * y.shape[2] * y.shape[3] * w.numel()
        return y

    x = torch.clamp_min(_bn2d(net, conv(x, "head.shared.conv"),
                              "head.shared.bn", eps, calib), 0.0)
    maps = []
    heads = [n for n, _ in m["head"]["heads"]] + ["hm"]
    for g in range(len(m["head"]["groups"])):
        out = {}
        for h in heads:
            p = f"head.groups.{g}.{h}"
            y = torch.clamp_min(_bn2d(net, conv(x, f"{p}.conv1"), f"{p}.bn",
                                      eps, calib), 0.0)
            out[h] = conv(y, f"{p}.conv2")[0]
        maps.append(out)
    return maps, flops


# -------------------------------------------------------------- decode, NMS
def decode_nms(cd: dict, maps):
    """Every group's kept boxes: (boxes (k, 9), scores (k,), labels (k,)),
    group after group, each in descending score, and the candidates over
    the gate before NMS."""
    m, d = cd["model"], cd["data"]
    pp, h = m["post"], m["head"]
    osf = h["out_size_factor"]
    lo, lim = d["point_cloud_range"], pp["center_limit_range"]
    out_b, out_s, out_l = [], [], []
    n_cand = 0
    for g, classes in enumerate(h["groups"]):
        mp = maps[g]
        nc, H, W = mp["hm"].shape
        scores = torch.sigmoid(mp["hm"]).reshape(-1)
        K = min(pp["max_obj_per_group"], scores.numel())
        srt = torch.sort(scores, descending=True, stable=True)
        s, i = srt.values[:K], srt.indices[:K]
        cls, cell = i // (H * W), i % (H * W)
        ys, xs = (cell // W).to(torch.float32), (cell % W).to(torch.float32)
        r = torch.cat([mp[n] for n, _ in h["heads"]]).reshape(-1, H * W)[:,
                                                                          cell]
        x = (xs + r[0]) * osf * d["voxel_size"][0] + lo[0]
        y = (ys + r[1]) * osf * d["voxel_size"][1] + lo[1]
        z = r[2]
        boxes = torch.stack([x, y, z, torch.exp(r[3]), torch.exp(r[4]),
                             torch.exp(r[5]), torch.atan2(r[7], r[6]), r[8],
                             r[9]], dim=-1)
        ok = s > pp["score_thresh"]
        for a, v in enumerate((x, y, z)):
            ok = ok & (v >= lim[a]) & (v <= lim[a + 3])
        cand = torch.nonzero(ok)[:, 0][:pp["nms_pre_maxsize"]]
        n_cand += int(cand.numel())
        keep = greedy_rotated_nms(boxes[cand, :7].double().cpu().numpy(),
                                  pp["nms_thresh"], pp["nms_post_maxsize"])
        sel = cand[torch.as_tensor(keep, dtype=torch.int64,
                                   device=cand.device)]
        ids = torch.tensor([CLASS_NAMES.index(c) + 1 for c in classes],
                           dtype=torch.int32, device=cls.device)
        out_b.append(boxes[sel])
        out_s.append(s[sel])
        out_l.append(ids[cls[sel]])
    return torch.cat(out_b), torch.cat(out_s), torch.cat(out_l), n_cand


def step(cd: dict, sd: dict, scans, tfs, *, device="cpu",
         dtype: str = "float32", tape: Tape | None = None, calib=None,
         with_maps: bool = False) -> dict:
    """One streaming step's outputs from the last W steps' sweeps and
    transforms (oldest first, None before the stream's start): kept boxes
    (k, 9) x, y, z, dx, dy, dz, yaw, vx, vy, scores (k,) and labels (k,)
    as numpy, the dense layers' FLOPs and the counts of points in range,
    voxels and candidates. ``calib``: a dict that every BN fills with its
    input's statistics, normalising with them (the weights' calibration);
    ``with_maps``: also the dense maps (numpy)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = Net(sd, dtype, tape)
    with torch.no_grad():
        pts, num, near = sweep_window(cd, scans, tfs, device)
        cloud = merged_cloud(cd, pts, num, near)
        sites, vfeat, n_in = voxelize(cd, cloud)
        x = T(sites, vfeat, net.tape.new(len(sites)) if tape is not None
              else 0)
        enc = backbone3d(net, cd, x, calib)
        if tape is not None:
            tape.roots = [enc.tid]
        maps, flops = dense_part(net, cd, height_compression(enc), calib)
        boxes, scores, labels, n_cand = decode_nms(cd, maps)
    out = dict(boxes=boxes.cpu().numpy(), scores=scores.cpu().numpy(),
               labels=labels.cpu().numpy(), dense_flops=flops,
               counts=dict(points=n_in, voxels=len(sites), candidates=n_cand))
    if with_maps:
        out["maps"] = [{k: v.cpu().numpy() for k, v in g.items()}
                       for g in maps]
    return out
