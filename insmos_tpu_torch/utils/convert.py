"""Torch (Lightning) checkpoint -> InsMOS parameter trees (the port's own
copy of ``insmos_tpu/utils/convert.py``; tests/test_torch_cli.py holds the
two equal).

The reference snapshots the full state_dict + hyperparameters in its
Lightning ckpts. This module maps that state_dict onto the numpy
param/state trees of the JAX package's layout, which
``utils.params.load_jax_params`` loads into the port's model and
``utils.checkpoint.save_checkpoint_from_trees`` writes as a port
checkpoint.

Layout transforms (validated numerically against torch in tests):
- Linear: torch (out, in) -> ours (in, out).
- Conv2d: torch OIHW -> ours HWIO.
- ConvTranspose2d (kernel == stride): torch (in, out, kh, kw) -> HWIO.
- BatchNorm: weight/bias -> scale/bias params; running_mean/var -> state.
- Sparse conv (spconv 2.x native layout (out, k0, k1, k2, in), kernel axes
  (kz, ky, kx) with kx fastest when flattened):
  -> ours (K, in, out) with K enumerated z-slowest / x-fastest — the same
  flattened order, so the transform is a pure transpose + reshape.
- MinkowskiEngine kernels ((K, in, out) already): pass-through.

MinkowskiEngine kernel-offset order (derivation, resolving the round-1
assumption): ME defines the generalized sparse convolution as
x_out(u) = sum_{i in N^D(u)} W_i x_in(u + i)  (Choy et al., CVPR'19, eq. 3;
implemented by kernel maps pairing in = out + offset) — i.e. CROSS-
CORRELATION, the same sign convention as torch Conv3d, spconv, and our
engine (make_offsets pairs weight[k] with +offset[k]; validated against
torch.nn.functional.conv3d on fully-dense grids in
tests/test_convert.py::test_subm_conv_matches_torch_dense*). The hypercube
region enumeration in ME 0.5.x (src/kernel_region.hpp, kernel_region::
coordinate_at) decomposes the linear kernel index with the FIRST coordinate
axis varying fastest: `for axis in 0..D-1: dst[axis] = lower[axis] +
(i % size[axis]); i /= size[axis]`. The reference builds ME coordinates as
[x, y, z, t] (motionnet.py:25-28), so kernel index k enumerates offsets
x-fastest / t-slowest over [-(s-1)/2, s/2] per dim (odd sizes centered,
even sizes [0, s) forward — ME kernel maps for even sizes are not
re-centered) — exactly our make_offsets order. Pass-through is therefore
the derived-correct mapping. `me_axis_perm` / `me_reverse_k` remain as
escape hatches for validating against a real released checkpoint (none is
available in this environment): reverse_k on a centered odd kernel equals
negating all offsets (the correlation<->convolution flip), and axis_perm
covers any enumeration-order permutation; both are exercised by
tests/test_convert.py::test_me_kernel_reorder_roundtrip.

Key mapping tables are explicit; unknown keys are reported, never guessed.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def t_conv2d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))  # OIHW -> HWIO


def t_conv2d_transpose(w: np.ndarray) -> np.ndarray:
    # torch (in, out, kh, kw); jax.lax.conv_transpose with HWIO and
    # transpose_kernel=False wants the kernel spatially FLIPPED relative to
    # torch's deconv placement (validated in tests/test_convert.py).
    w = np.flip(w, axis=(2, 3))
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def t_spconv(w: np.ndarray) -> np.ndarray:
    """spconv 2.x native (out, k0, k1, k2, in) -> (K, in, out)."""
    out_c, k0, k1, k2, in_c = w.shape
    w = np.transpose(w, (1, 2, 3, 4, 0))  # (k0, k1, k2, in, out)
    return np.ascontiguousarray(w.reshape(k0 * k1 * k2, in_c, out_c))


def t_me_kernel(
    w: np.ndarray,
    reverse_k: bool = False,
    kernel_size: tuple[int, ...] | None = None,
    axis_perm: tuple[int, ...] | None = None,
) -> np.ndarray:
    """ME kernel (K, in, out) -> ours (K, in, out).

    Identity by derivation (see module docstring): ME enumerates hypercube
    offsets first-axis-fastest over [x, y, z, t] coordinates — the same
    order as make_offsets. `axis_perm` (a permutation of the spatial axes,
    requires kernel_size) and `reverse_k` are escape hatches for checkpoint
    validation against a permuted/flipped enumeration hypothesis.
    """
    if axis_perm is not None:
        assert kernel_size is not None, "axis_perm needs kernel_size"
        K, cin, cout = w.shape
        assert K == int(np.prod(kernel_size))
        # our canonical index: axis 0 fastest -> unflatten reversed (C-order)
        wk = w.reshape(*kernel_size[::-1], cin, cout)
        d = len(kernel_size)
        # permute spatial axes (perm given in axis-0-fastest convention)
        rev_perm = [d - 1 - axis_perm[d - 1 - a] for a in range(d)]
        wk = np.transpose(wk, (*rev_perm, d, d + 1))
        w = wk.reshape(K, cin, cout)
    return np.ascontiguousarray(w[::-1] if reverse_k else w)


def _bn(sd: dict, prefix: str, used: set | None = None):
    p = {"scale": np.asarray(sd[prefix + ".weight"]), "bias": np.asarray(sd[prefix + ".bias"])}
    s = {
        "mean": np.asarray(sd[prefix + ".running_mean"]),
        "var": np.asarray(sd[prefix + ".running_var"]),
    }
    if used is not None:
        used.update(prefix + x for x in
                    (".weight", ".bias", ".running_mean", ".running_var"))
    return p, s


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Read a Lightning ckpt's state_dict as numpy (no GPU deps needed)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}, ckpt.get(
        "hyper_parameters", {}
    )


# --------------------------------------------------------------- UNet map
def convert_unet(sd: dict, params: dict, state: dict, used: set) -> None:
    """Map reference model.unet.* keys onto our unet3d param tree."""
    U = "model.unet."

    def conv_bn(ours: str, conv_key: str, bn_key: str):
        params[ours]["conv"]["w"] = t_spconv(sd[U + conv_key])
        p, s = _bn(sd, U + bn_key, used)
        params[ours]["bn"], state[ours]["bn"] = p, s
        used.add(U + conv_key)

    conv_bn("conv_input", "conv_input.0.weight", "conv_input.1")
    conv_bn("conv1", "conv1.0.0.weight", "conv1.0.1")
    for lvl in (2, 3, 4):
        conv_bn(f"conv{lvl}_down", f"conv{lvl}.0.0.weight", f"conv{lvl}.0.1")
        conv_bn(f"conv{lvl}_a", f"conv{lvl}.1.0.weight", f"conv{lvl}.1.1")
        conv_bn(f"conv{lvl}_b", f"conv{lvl}.2.0.weight", f"conv{lvl}.2.1")
    conv_bn("conv_out", "conv_out.0.weight", "conv_out.1")

    params["inv_conv_out"]["conv"]["w"] = t_spconv(sd[U + "inv_conv_out.weight"])
    used.add(U + "inv_conv_out.weight")

    fuse_map = {
        "fuse4": "conv_up_instance_block",
        "fuse3": "conv_up_instance_block_up4",
        "fuse2": "conv_up_instance_block_up3",
        "fuse1": "conv_up_instance_block_up2",
        "fuse1_final": "conv_up_instance_block_up1",
    }
    for ours, theirs in fuse_map.items():
        conv_bn(ours, f"{theirs}.0.weight", f"{theirs}.1")

    for lvl in (4, 3, 2, 1):
        t = f"conv_up_t{lvl}"
        p = params[f"up_t{lvl}"]
        s = state[f"up_t{lvl}"]
        p["conv1"]["w"] = t_spconv(sd[U + t + ".conv1.weight"])
        p["conv2"]["w"] = t_spconv(sd[U + t + ".conv2.weight"])
        p["bn1"], s["bn1"] = _bn(sd, U + t + ".bn1", used)
        p["bn2"], s["bn2"] = _bn(sd, U + t + ".bn2", used)
        used.update({U + t + ".conv1.weight", U + t + ".conv2.weight"})
        conv_bn(f"up_m{lvl}", f"conv_up_m{lvl}.0.weight", f"conv_up_m{lvl}.1")
    conv_bn("inv4", "inv_conv4.0.weight", "inv_conv4.1")
    conv_bn("inv3", "inv_conv3.0.weight", "inv_conv3.1")
    conv_bn("inv2", "inv_conv2.0.weight", "inv_conv2.1")
    conv_bn("up_out", "conv_up_out.0.0.weight", "conv_up_out.0.1")

    params["mos_head"]["w"] = t_linear(sd[U + "mos_seg_layer.weight"])
    params["mos_head"]["b"] = np.asarray(sd[U + "mos_seg_layer.bias"])
    used.update({U + "mos_seg_layer.weight", U + "mos_seg_layer.bias"})


def convert_bev_and_head(sd: dict, params: dict, used: set) -> None:
    B = "model.unet.bev_backbone."
    blk = params["bev"]["blocks"][0]
    # reference block layout: [ZeroPad2d, Conv2d, BN, ReLU] + 5x[Conv2d, BN, ReLU]
    torch_idx = [1] + [4 + 3 * i for i in range(len(blk["convs"]) - 1)]
    for k, ti in enumerate(torch_idx):
        blk["convs"][k]["w"] = t_conv2d(sd[B + f"blocks.0.{ti}.weight"])
        p, s = _bn(sd, B + f"blocks.0.{ti + 1}", used)
        blk["bns"][k] = p
        params["_bev_state"]["blocks"][0]["bns"][k] = s
        used.add(B + f"blocks.0.{ti}.weight")
    d = params["bev"]["deblocks"][0]
    d["conv"]["w"] = t_conv2d_transpose(sd[B + "deblocks.0.0.weight"])
    p, s = _bn(sd, B + "deblocks.0.1", used)
    d["bn"] = p
    params["_bev_state"]["deblocks"][0]["bn"] = s
    used.add(B + "deblocks.0.0.weight")

    H = "model.unet.center_head."
    params["head"]["cls"]["w"] = t_conv2d(sd[H + "conv_cls.weight"])
    params["head"]["cls"]["b"] = np.asarray(sd[H + "conv_cls.bias"])
    params["head"]["box"]["w"] = t_conv2d(sd[H + "conv_box.weight"])
    params["head"]["box"]["b"] = np.asarray(sd[H + "conv_box.bias"])
    used.update(H + k for k in
                ("conv_cls.weight", "conv_cls.bias", "conv_box.weight", "conv_box.bias"))


def convert_motionnet(sd: dict, params: dict, state: dict, used: set,
                      reverse_k: bool = False) -> None:
    M = "model.motion_encoder.MinkUNet."

    def conv_bn(ours, conv_key, bn_key):
        params[ours]["conv"]["w"] = t_me_kernel(sd[M + conv_key], reverse_k)
        p, s = _bn(sd, M + bn_key + ".bn", used)
        params[ours]["bn"], state[ours]["bn"] = p, s
        used.add(M + conv_key)

    conv_bn("stem", "conv0p1s1.kernel", "bn0")
    conv_bn("down1", "conv1p1s2.kernel", "bn1")
    conv_bn("down2", "conv2p2s2.kernel", "bn2")
    conv_bn("down3", "conv3p4s2.kernel", "bn3")
    conv_bn("up5", "convtr5p8s2.kernel", "bntr5")
    conv_bn("up6", "convtr6p4s2.kernel", "bntr6")
    conv_bn("up7", "convtr7p2s2.kernel", "bntr7")

    block_map = {"block1": "block1.0", "block2": "block2.0", "block3": "block3.0",
                 "block6": "block6.0", "block7": "block7.0", "block8": "block8.0"}
    for ours, theirs in block_map.items():
        p, s = params[ours], state[ours]
        p["conv1"]["w"] = t_me_kernel(sd[M + theirs + ".conv1.kernel"], reverse_k)
        p["conv2"]["w"] = t_me_kernel(sd[M + theirs + ".conv2.kernel"], reverse_k)
        p["bn1"], s["bn1"] = _bn(sd, M + theirs + ".norm1.bn", used)
        p["bn2"], s["bn2"] = _bn(sd, M + theirs + ".norm2.bn", used)
        if "down" in p:
            dk = sd[M + theirs + ".downsample.0.kernel"]
            p["down"]["w"] = dk.reshape(1, *dk.shape) if dk.ndim == 2 else dk
            p["down_bn"], s["down_bn"] = _bn(sd, M + theirs + ".downsample.1.bn", used)
            used.add(M + theirs + ".downsample.0.kernel")
        used.update({M + theirs + ".conv1.kernel", M + theirs + ".conv2.kernel"})

    fk = sd[M + "final.kernel"]
    params["final"]["w"] = fk if fk.ndim == 2 else fk[0]
    params["final"]["b"] = np.asarray(sd[M + "final.bias"])
    used.update({M + "final.kernel", M + "final.bias"})


def convert_checkpoint(torch_ckpt_path: str, params, state, me_reverse_k=False):
    """Fill our (params, state) pytrees in place from a reference ckpt.

    Returns (params, state, unused_torch_keys) — inspect unused keys to
    confirm full coverage.
    """
    sd, _hparams = load_torch_state_dict(torch_ckpt_path)
    used: set[str] = set()
    # temporary handle so the BEV converter can reach its BN state
    params = dict(params)
    params["_bev_state"] = state["bev"]
    convert_unet(sd, params["unet"], state["unet"], used)
    convert_bev_and_head(sd, params, used)
    convert_motionnet(sd, params["motion"], state["motion"], used, me_reverse_k)
    params.pop("_bev_state")
    unused = [k for k in sd
              if k not in used and not k.endswith(".num_batches_tracked")]
    return params, state, unused
