"""Parameters without jax: random init and loading of the JAX package's
parameter trees.

``init_params`` makes numpy trees with the same structure, shapes and
dtypes as ``insmos_tpu.nn.model.InsMOSModel.init`` (BN running statistics
included), from a ``numpy.random.Generator``. ``load_jax_params`` turns such
trees (or the JAX package's own, as numpy arrays) into a state dict of
``InsMOSModel``: tree paths joined with "." are the module names, and only
the 2D conv weights change layout (HWIO -> torch's).
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, size=shape).astype(_F32)


def _bn(rng, c):
    """BN params and running stats, drawn away from (1, 0, 0, 1) so that
    eval-mode BatchNorm is exercised."""
    p = {"scale": rng.uniform(0.8, 1.2, c).astype(_F32),
         "bias": (0.05 * rng.standard_normal(c)).astype(_F32)}
    s = {"mean": (0.1 * rng.standard_normal(c)).astype(_F32),
         "var": rng.uniform(0.5, 1.5, c).astype(_F32)}
    return p, s


def _sparse_conv(rng, K, cin, cout):
    return {"w": _uniform(rng, (K, cin, cout), 1.0 / np.sqrt(K * cin))}


def _conv_bn(rng, K, cin, cout):
    bp, bs = _bn(rng, cout)
    return {"conv": _sparse_conv(rng, K, cin, cout), "bn": bp}, {"bn": bs}


def _basic_block(rng, K, cin, cout, downsample):
    p = {"conv1": _sparse_conv(rng, K, cin, cout)}
    s = {}
    p["bn1"], s["bn1"] = _bn(rng, cout)
    p["conv2"] = _sparse_conv(rng, K, cout, cout)
    p["bn2"], s["bn2"] = _bn(rng, cout)
    if downsample:
        p["down"] = _sparse_conv(rng, 1, cin, cout)
        p["down_bn"], s["down_bn"] = _bn(rng, cout)
    return p, s


def _linear(rng, cin, cout):
    b = 1.0 / np.sqrt(cin)
    return {"w": _uniform(rng, (cin, cout), b), "b": _uniform(rng, (cout,), b)}


def _motion(rng, cfg):
    mc = cfg.model.motionnet
    pl, d0 = mc.planes, mc.init_dim
    P, S = {}, {}
    for name, (K, cin, cout) in (("stem", (125, 1, d0)), ("down1", (8, d0, d0))):
        P[name], S[name] = _conv_bn(rng, K, cin, cout)
    P["block1"], S["block1"] = _basic_block(rng, 81, d0, pl[0], d0 != pl[0])
    P["down2"], S["down2"] = _conv_bn(rng, 8, pl[0], pl[0])
    P["block2"], S["block2"] = _basic_block(rng, 81, pl[0], pl[1], True)
    P["down3"], S["down3"] = _conv_bn(rng, 8, pl[1], pl[1])
    P["block3"], S["block3"] = _basic_block(rng, 81, pl[1], pl[2], True)
    P["up5"], S["up5"] = _conv_bn(rng, 8, pl[2], pl[5])
    P["block6"], S["block6"] = _basic_block(rng, 81, pl[5] + pl[1], pl[5], True)
    P["up6"], S["up6"] = _conv_bn(rng, 8, pl[5], pl[6])
    P["block7"], S["block7"] = _basic_block(rng, 81, pl[6] + pl[0], pl[6], True)
    P["up7"], S["up7"] = _conv_bn(rng, 8, pl[6], pl[7])
    P["block8"], S["block8"] = _basic_block(rng, 81, pl[7] + d0, pl[7], True)
    P["final"] = _linear(rng, pl[7], mc.out_channels)
    return P, S


def _unet(rng, cfg):
    ch = cfg.model.unet_channels
    nc = cfg.model.head.num_class
    cin = cfg.model.point_features + 3
    P, S = {}, {}

    def add(name, ps):
        P[name], S[name] = ps

    add("conv_input", _conv_bn(rng, 27, cin, ch[0]))
    add("conv1", _conv_bn(rng, 27, ch[0], ch[0]))
    for lvl in (2, 3, 4):
        add(f"conv{lvl}_down", _conv_bn(rng, 27, ch[lvl - 2], ch[lvl - 1]))
        add(f"conv{lvl}_a", _conv_bn(rng, 27, ch[lvl - 1], ch[lvl - 1]))
        add(f"conv{lvl}_b", _conv_bn(rng, 27, ch[lvl - 1], ch[lvl - 1]))
    add("conv_out", _conv_bn(rng, 3, ch[3], ch[3]))
    P["inv_conv_out"] = {"conv": {"w": (rng.standard_normal(
        (3, ch[3], ch[3])) / np.sqrt(3 * ch[3])).astype(_F32)}}
    add("fuse4", _conv_bn(rng, 27, ch[3] + nc, ch[3]))
    add("fuse3", _conv_bn(rng, 27, ch[2] + nc, ch[2]))
    add("fuse2", _conv_bn(rng, 27, ch[1] + nc, ch[1]))
    add("fuse1", _conv_bn(rng, 27, ch[0] + nc, ch[0]))
    add("fuse1_final", _conv_bn(rng, 27, ch[0] + nc, ch[0]))
    for lvl, c in ((4, ch[3]), (3, ch[2]), (2, ch[1]), (1, ch[0])):
        add(f"up_t{lvl}", _basic_block(rng, 27, c, c, False))
        add(f"up_m{lvl}", _conv_bn(rng, 27, 2 * c, c))
    add("inv4", _conv_bn(rng, 27, ch[3], ch[2]))
    add("inv3", _conv_bn(rng, 27, ch[2], ch[1]))
    add("inv2", _conv_bn(rng, 27, ch[1], ch[0]))
    add("up_out", _conv_bn(rng, 27, ch[0], ch[0]))
    P["mos_head"] = _linear(rng, ch[0], 3)
    return P, S


def _bev(rng, cfg):
    b = cfg.model.bev
    P = {"blocks": [], "deblocks": []}
    S = {"blocks": [], "deblocks": []}
    for lvl in range(len(b.layer_nums)):
        c_in = b.num_bev_features if lvl == 0 else b.num_filters[lvl - 1]
        nf = b.num_filters[lvl]
        convs, bps, bss = [], [], []
        for k in range(b.layer_nums[lvl] + 1):
            src = c_in if k == 0 else nf
            convs.append({"w": _uniform(rng, (3, 3, src, nf),
                                        1.0 / np.sqrt(9 * src))})
            bp, bs = _bn(rng, nf)
            bps.append(bp)
            bss.append(bs)
        P["blocks"].append({"convs": convs, "bns": bps})
        S["blocks"].append({"bns": bss})
        s, nu = b.upsample_strides[lvl], b.num_upsample_filters[lvl]
        bp, bs = _bn(rng, nu)
        P["deblocks"].append({"conv": {"w": _uniform(
            rng, (s, s, nf, nu), 1.0 / np.sqrt(s * s * nf))}, "bn": bp})
        S["deblocks"].append({"bn": bs})
    return P, S


def _head(rng, cfg):
    c_in = cfg.model.bev.num_upsample_filters[0]
    nc = cfg.model.head.num_class
    b = 1.0 / np.sqrt(c_in)
    # class bias 0 (the reference starts at -log(99)): random weights then
    # put a share of the heatmap above the score gate, so that top-K, NMS
    # and the box fusion run on real candidates
    return {
        "cls": {"w": _uniform(rng, (1, 1, c_in, nc), b),
                "b": np.zeros((nc,), _F32)},
        "box": {"w": (1e-3 * rng.standard_normal((1, 1, c_in, 8))).astype(_F32),
                "b": np.zeros((8,), _F32)},
    }


def init_params(cfg, rng: np.random.Generator):
    """Random (params, state) numpy trees shaped like InsMOSModel.init."""
    mp, ms = _motion(rng, cfg)
    up, us = _unet(rng, cfg)
    bp, bs = _bev(rng, cfg)
    hp = _head(rng, cfg)
    return ({"motion": mp, "unet": up, "bev": bp, "head": hp},
            {"motion": ms, "unet": us, "bev": bs})


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def load_jax_params(params_np, state_np, device) -> dict:
    """(params, state) trees of numpy arrays -> state dict of InsMOSModel
    on ``device``. BEV conv weights move from HWIO to torch's layouts (the
    transposed conv also flips its kernel: the reference's conv_transpose
    correlates with the spatially flipped kernel)."""
    flat = _flatten(params_np, "", {})
    _flatten(state_np, "", flat)
    sd = {}
    for k, v in flat.items():
        if k.startswith("bev.blocks.") and ".convs." in k:
            v = v.transpose(3, 2, 0, 1)
        elif k.startswith("bev.deblocks.") and k.endswith(".conv.w"):
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        sd[k] = torch.from_numpy(np.ascontiguousarray(v, dtype=_F32)).to(
            device)
    return sd


def make_model(cfg, params_np, state_np, device):
    """InsMOSModel on ``device`` holding the given parameter trees."""
    from ..nn.model import InsMOSModel

    model = InsMOSModel(cfg).to(device)
    model.load_state_dict(load_jax_params(params_np, state_np, device),
                          strict=True)
    return model.eval()
