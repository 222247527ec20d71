"""Span convolution: the plan and the op (port of
insmos_tpu/sparse/span_conv.py).

Sites are sorted by 3D key, so the input rows that a block of ``bs``
consecutive output sites needs for one (dy, dz) kernel-offset group form a
bounded, nearly contiguous span of the sorted input array. The PLAN
(``make_span_plans``) finds, per (group, block), the span start ``sb`` by
bisection; (group, block) pairs whose key interval is wider than ``span``
rows get greedy coverage windows ("slots", ``gs``). ``n_overflow`` counts
the (site, group) rows that no window covers; 0 certifies that the conv is
exact. The OP (``span_conv_parts``) computes, for every output site, the
sum over groups g and x-taps d of feats[row] @ W[g, d], where a tap
contributes only if its input key lies in the block's main window
``[sb*16, sb*16 + span)`` or in one of the block's slot windows at rows
``>= excl`` -- the span-restricted semantics of the TPU kernels, which the
port keeps so that plans with ``n_overflow > 0`` agree too.

The op (``insmos::span_conv``, a ``torch.library`` custom op) runs the
hand-written CUDA kernel of ``csrc/span_conv.cu`` for CUDA tensors and its
plain PyTorch version (``span_conv_core_plain``) for CPU tensors. There is
no fallback between the two. Its batching rule serves the multi-stream
pod's step, which ``torch.func.vmap`` runs over the slots of a card: one
kernel launch covers every slot, as the JAX package's vmap gives the TPU
kernels a slot axis on their grid.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import math

import torch

from .. import obs
from ..kernels import bound
from .slab import INT32_MAX, Slab, _compact_by_sort, _groups_yz, t_band
from .tensor import KEY_SENTINEL

BS = 128  # output sites per block
SPAN = 256  # input rows per (block, group) main window
BIGQ = 0x7FFFFF00  # query sentinel above any grid key, safe against +kx


def _bisect(keys, queries):
    """First index with key >= query over sorted keys (any query shape)."""
    q = queries.to(keys.dtype).contiguous()
    return torch.searchsorted(keys, q.reshape(-1), side="left").to(
        torch.int32).reshape(queries.shape)


def fold_weights(weight, kx, G, kt, T, dtype, T_out=None, t0_off=0):
    """(K, cin, cout) -> (G, kx*T*cin, T_out*cout) with the t-kernel folded
    in as a (T, T_out) band. Each folded entry is a copy of one weight, so
    folding in float32 and casting equals folding in ``dtype``."""
    K, cin, cout = weight.shape
    if T_out is None:
        T_out = T
    w5 = weight.reshape(kt, G, kx, cin, cout).float()
    bands = t_band(kt, T, T_out, t0_off, torch.float32, weight.device)
    return torch.einsum("igdco,itp->gdtcpo", w5, bands).reshape(
        G, kx * T * cin, T_out * cout
    ).to(dtype)


@dataclasses.dataclass(frozen=True)
class ConvPart:
    """Static descriptor of one input segment of a multi-part span conv:
    conv(cat(a, b), W) == conv_parts([a, b], [W[:, :Ca], W[:, Ca:]])."""

    cin: int
    cout: int
    T: int
    kt: int = 1
    in_off: int = 0  # column offset of this part's T*cin block in feats_cat
    out_off: int = 0  # column offset of this part's T_out*cout output block
    t0_off: int = 0


def fold_weights_parts(weights, parts, kx, G, T_out, dtype, TC_tot, TO_tot):
    """Fold each part's weight into the joint (G, kx*TC_tot, TO_tot) matrix
    at its (in_off, out_off) block (parts' row ranges are disjoint)."""
    dev = weights[0].device
    wg4 = torch.zeros((G, kx, TC_tot, TO_tot), dtype=torch.float32, device=dev)
    for w, pt in zip(weights, parts):
        wp = fold_weights(w, kx, G, pt.kt, pt.T, torch.float32, T_out=T_out,
                          t0_off=pt.t0_off).reshape(G, kx, pt.T * pt.cin,
                                                    T_out * pt.cout)
        wg4[:, :, pt.in_off:pt.in_off + pt.T * pt.cin,
            pt.out_off:pt.out_off + T_out * pt.cout] = wp
    return wg4.reshape(G, kx * TC_tot, TO_tot).to(dtype)


@dataclasses.dataclass
class SpanPlan:
    """Per-(output site set, kernel geometry) span metadata."""

    sb: torch.Tensor  # (G, NB) int32 main-window starts, 16-row units
    se: torch.Tensor  # (G, NB) int32 span ends, 16-row units (ceil)
    emp: torch.Tensor  # (G, NB) int32: 1 = no input key in the pair's range
    gp: torch.Tensor  # (G, 2) int32 (ky_i, kz_i)
    n_overflow: torch.Tensor  # () coverage counter (0 == exact)
    gs: torch.Tensor  # (4, JS) int32 slots: (group, block or -1, start
    # tile, exclusion row), sorted by (block, group), dead slots last
    kernel3: tuple
    stride3: tuple
    pad3: tuple
    in_dims: tuple
    span: int = SPAN
    bs: int = BS
    js: int = 0
    gwin: int = 12
    jp: int = 0

    def conv(self, x: Slab, weight, out: Slab, kernel, t0_off: int = 0) -> Slab:
        kt = kernel[3] if len(kernel) == 4 else 1
        feats = span_conv_apply(
            x.keys, x.mask_feats(), out.coords, out.valid, weight, self, x.T,
            kt, out.T, t0_off,
        )
        res = out.replace_feats(feats)
        return res.replace_feats(res.mask_feats())

    def conv_with_occ(self, x: Slab, weight, out: Slab, kernel) -> Slab:
        """Strided conv that also propagates occupancy (OR over gathered
        children): the occupancy rides as a second part with a ones weight,
        landing after the feature outputs."""
        kt = kernel[3] if len(kernel) == 4 else 1
        assert kt == 1, "occ folding assumes a t-kernel of 1 (down convs)"
        K, cin, cout = weight.shape
        T = x.T
        f = x.mask_feats()
        occf = torch.where(x.valid[:, None], x.occ, False).to(f.dtype)
        fa = torch.cat([f, occf], dim=-1)
        TO = T * cout
        parts = (ConvPart(cin, cout, T, 1, 0, 0),
                 ConvPart(1, 1, T, 1, T * cin, TO))
        w_occ = torch.ones((K, 1, 1), dtype=weight.dtype, device=weight.device)
        feats = span_conv_parts(
            x.keys, fa, [weight, w_occ], parts, out.coords, out.valid, self, T
        )
        occ = (feats[:, TO:TO + T] > 0.5) & out.valid[:, None]
        res = Slab(out.keys, out.coords, occ, feats[:, :TO], out.valid,
                   out.dims, out.T)
        return res.replace_feats(res.mask_feats())

    def conv_cat(self, a: Slab, b: Slab, weight, out: Slab, kernel,
                 t0_off: int = 0) -> Slab:
        """Conv over the channel concat of two slabs on one site set,
        without materialising the per-t interleaved cat."""
        kt = kernel[3] if len(kernel) == 4 else 1
        ca, cb = a.num_features, b.num_features
        cout = weight.shape[2]
        T = a.T
        fa = torch.cat([a.mask_feats(), b.mask_feats()], dim=-1)
        parts = (ConvPart(ca, cout, T, kt, 0, 0, t0_off),
                 ConvPart(cb, cout, T, kt, T * ca, 0, t0_off))
        feats = span_conv_parts(
            a.keys, fa, [weight[:, :ca], weight[:, ca:]], parts, out.coords,
            out.valid, self, out.T,
        )
        res = out.replace_feats(feats)
        return res.replace_feats(res.mask_feats())


# ------------------------------------------------------------------- plan
def _pad_rows(a, n, fill):
    if a.shape[0] >= n:
        return a
    pad = torch.full((n - a.shape[0],) + tuple(a.shape[1:]), fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


_GROUP_OFFSETS: dict = {}  # (kernel3, device) -> (ky, kz)


def _group_offsets(kernel3, device):
    """(ky, kz), each (G,) int64 on ``device``: the (dy, dz) offsets of the
    kernel's groups (``_groups_yz``), uploaded once. An upload from host
    memory at every plan would block the host, and a CUDA graph cannot
    hold one."""
    key = (tuple(kernel3), torch.device(device))
    offsets = _GROUP_OFFSETS.get(key)
    if offsets is None:
        groups = _groups_yz(kernel3)
        # ordinary tensors, though a plan may first run in inference mode
        with torch.inference_mode(False):
            offsets = tuple(torch.tensor([g[i] for g in groups],
                                         dtype=torch.int64, device=device)
                            for i in (0, 1))
        _GROUP_OFFSETS[key] = offsets
    return offsets


def _plan_ctx(out_coords, out_valid, kernel3, stride3, pad3, in_dims, span,
              bs, slots, gwin, pairs, Vin):
    """Everything a plan needs before its main bisection. Returns (firsts,
    lasts + kx, ctx); several plans over one key array share one bisection
    (make_span_plans)."""
    dev = out_coords.device
    kx = int(kernel3[0])
    if pad3 is None:
        pad3 = tuple((k - 1) // 2 for k in kernel3)
    G = len(_groups_yz(kernel3))
    V = out_coords.shape[0]
    NB = -(-V // bs)
    Vp = NB * bs
    if slots is None:
        slots = 0 if NB < 4 else min(4096, max(128, NB))
    if pairs is None:
        pairs = slots

    ocoords = _pad_rows(out_coords.to(torch.int32), Vp, 0)
    ovalid = _pad_rows(out_valid.to(torch.int32), Vp, 0)
    ky, kz = _group_offsets(kernel3, dev)

    X, Y, Z = in_dims
    sx, sy, sz = stride3
    px, py, pz = pad3
    c = ocoords.to(torch.int64)
    iy = c[:, 1] * sy - py + ky[:, None]
    iz = c[:, 2] * sz - pz + kz[:, None]
    row_ok = (ovalid[None] > 0) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    q = (iz * Y + iy) * X + (c[:, 0] * sx - px)[None]
    q_all = torch.where(row_ok, q, INT32_MAX)  # (G, Vp)
    qb = q_all.reshape(G, NB, bs)
    firsts = qb.min(dim=2).values
    lasts = torch.where(qb == INT32_MAX, -1, qb).max(dim=2).values
    ctx = dict(
        kernel3=tuple(kernel3), stride3=tuple(stride3), pad3=tuple(pad3),
        in_dims=tuple(in_dims), span=span, bs=bs, js=slots, gwin=gwin,
        jp=pairs, kx=kx, G=G, NB=NB, Vin=Vin, ocoords=ocoords, ovalid=ovalid,
        nvalid_blk=ovalid.reshape(NB, bs).sum(dim=1), ky=ky, kz=kz,
    )
    return firsts, lasts + kx, ctx


def make_span_plans(x_keys, requests) -> list:
    """Plans for several output site sets over one sorted key array.

    requests: dicts with out_coords, out_valid, kernel3, in_dims and the
    optional stride3, pad3, span, bs, slots, gwin, pairs. Inside a
    :meth:`PlanGraphs.step` on CUDA tensors the plans come from a replay
    of the graph of this code (see :class:`PlanGraphs`)."""
    with obs.span("plan"):
        obs.count("plan.builds")
        graphs = _graphs_for(x_keys, requests)
        if graphs is not None:
            return graphs.replay(x_keys, requests)
        return _make_span_plans(x_keys, requests)


def _make_span_plans(x_keys, requests, exact_stats: bool = False) -> list:
    Vin = x_keys.shape[0]
    preps = []
    for r in requests:
        r = dict(r)
        preps.append(_plan_ctx(
            r.pop("out_coords"), r.pop("out_valid"), r.pop("kernel3"),
            r.pop("stride3", (1, 1, 1)), r.pop("pad3", None),
            r.pop("in_dims"), r.pop("span", SPAN), r.pop("bs", BS),
            r.pop("slots", None), r.pop("gwin", 12), r.pop("pairs", None),
            Vin,
        ))
        if r:
            raise ValueError(f"unknown plan request keys: {sorted(r)}")
    q = torch.cat([torch.cat([f.reshape(-1), l.reshape(-1)])
                   for f, l, _ in preps])
    pos = _bisect(x_keys, q)
    plans = []
    off = 0
    for f, l, ctx in preps:
        n = f.numel()
        pos2 = torch.stack([pos[off:off + n].reshape(f.shape),
                            pos[off + n:off + 2 * n].reshape(f.shape)])
        off += 2 * n
        plans.append(_plan_finish(x_keys, pos2, ctx, exact_stats=exact_stats))
    return plans


def make_span_plan(x_keys, out_coords, out_valid, kernel3, stride3=(1, 1, 1),
                   pad3=None, in_dims=None, span: int = SPAN, bs: int = BS,
                   slots: int | None = None, gwin: int = 12,
                   pairs: int | None = None, exact_stats: bool = False):
    """One plan (see the module docstring). ``exact_stats=True`` replaces
    n_overflow by an exact per-row count of uncovered window rows (tools),
    and is always built eagerly; otherwise, inside a
    :meth:`PlanGraphs.step` on CUDA tensors, the plan comes from a replay
    of the graph of this code."""
    with obs.span("plan"):
        obs.count("plan.builds")
        request = dict(out_coords=out_coords, out_valid=out_valid,
                       kernel3=kernel3, stride3=stride3, pad3=pad3,
                       in_dims=in_dims, span=span, bs=bs, slots=slots,
                       gwin=gwin, pairs=pairs)
        graphs = _graphs_for(x_keys, [request])
        if graphs is not None and not exact_stats:
            return graphs.replay(x_keys, [request])[0]
        return _make_span_plans(x_keys, [request], exact_stats)[0]


def _plan_finish(x_keys, pos2, ctx, exact_stats: bool = False) -> SpanPlan:
    span, bs = ctx["span"], ctx["bs"]
    js, gwin, jp, kx, G, NB = (ctx["js"], ctx["gwin"], ctx["jp"], ctx["kx"],
                               ctx["G"], ctx["NB"])
    Vin = ctx["Vin"]
    ocoords, ovalid = ctx["ocoords"], ctx["ovalid"]
    ky, kz = ctx["ky"], ctx["kz"]
    X, Y, Z = ctx["in_dims"]
    sx, sy, sz = ctx["stride3"]
    px, py, pz = ctx["pad3"]
    dev = x_keys.device
    i32 = torch.int32

    pos2 = pos2.to(torch.int64)
    sb = torch.div(pos2[0], 16, rounding_mode="floor")
    send = pos2[1]
    se = -torch.div(-send, 16, rounding_mode="floor")
    emp = (pos2[1] <= pos2[0]).to(i32)
    live_b = ctx["nvalid_blk"] > 0
    jump = (send - sb * 16 > span) & live_b[None]
    gp = torch.stack([ky, kz], dim=1).to(i32)

    if js > 0:
        GNB = G * NB
        iota_p = torch.arange(GNB, dtype=torch.int64, device=dev)
        jf = jump.reshape(-1)
        n_pairs = jf.sum()
        sel = _compact_by_sort(torch.where(jf, iota_p, INT32_MAX), iota_p, jp,
                               0)
        sel_ok = torch.arange(jp, device=dev) < n_pairs
        pg = torch.div(sel, NB, rounding_mode="floor")
        pb = sel % NB
        site_idx = (pb[:, None] * bs
                    + torch.arange(bs, device=dev)[None]).reshape(-1)
        c3 = ocoords[site_idx].to(torch.int64).reshape(jp, bs, 3)
        v = ovalid[site_idx].reshape(jp, bs)
        iy = c3[..., 1] * sy - py + ky[pg][:, None]
        iz = c3[..., 2] * sz - pz + kz[pg][:, None]
        rowok = ((v > 0) & sel_ok[:, None] & (iy >= 0) & (iy < Y)
                 & (iz >= 0) & (iz < Z))
        qa = torch.where(rowok, (iz * Y + iy) * X + (c3[..., 0] * sx - px),
                         BIGQ)  # (jp, bs)

        kpad_keys = torch.cat([x_keys.to(torch.int64),
                               torch.full((1,), INT32_MAX, dtype=torch.int64,
                                          device=dev)])

        def key_at(pos):
            return kpad_keys[pos.clamp(0, Vin)]

        E = sb.reshape(-1)[sel] * 16 + span  # (jp,) coverage end (rows)
        sl_g, sl_b, sl_r, sl_e = [], [], [], []

        def greedy_round(qa_t, pg_t, pb_t, E_t):
            Kcov = key_at(E_t)
            unc = (qa_t + kx > Kcov[:, None]) & (qa_t < BIGQ)
            A = torch.where(unc, qa_t, BIGQ).min(dim=1).values
            need = A < BIGQ
            posA = _bisect(x_keys, torch.where(need, A, 0)).to(torch.int64)
            r_w = torch.div(posA, 16, rounding_mode="floor")
            sl_g.append(torch.where(need, pg_t, 0))
            sl_b.append(torch.where(need, pb_t, -1))
            sl_r.append(torch.where(need, r_w, 0))
            sl_e.append(torch.where(need, E_t, 0))
            return torch.where(need, torch.maximum(E_t, r_w * 16 + span), E_t)

        # tier 1: a few rounds over all pairs; tier 2: the long tail,
        # compacted to a smaller pair set
        tier1 = min(gwin, 4)
        for _ in range(tier1):
            E = greedy_round(qa, pg, pb, E)
        if gwin > tier1:
            Kcov = key_at(E)
            undone = ((qa + kx > Kcov[:, None]) & (qa < BIGQ)).any(dim=1)
            jp2 = max(256, jp // 4)
            iota2 = torch.arange(jp, dtype=torch.int64, device=dev)
            sel2 = _compact_by_sort(torch.where(undone, iota2, INT32_MAX),
                                    iota2, jp2, 0)
            ok2 = torch.arange(jp2, device=dev) < undone.sum()
            qa2 = torch.where(ok2[:, None], qa[sel2], BIGQ)
            pg2 = pg[sel2]
            pb2 = torch.where(ok2, pb[sel2], -1)
            E2 = E[sel2]
            for _ in range(gwin - tier1):
                E2 = greedy_round(qa2, pg2, pb2, E2)
            E = E.scatter_reduce(0, torch.where(ok2, sel2, jp - 1),
                                 torch.where(ok2, E2, 0), reduce="amax")
        Kcov = key_at(E)
        n_viol = ((qa + kx > Kcov[:, None]) & (qa < BIGQ)).sum()

        fb = torch.cat(sl_b)
        fg = torch.cat(sl_g)
        fr = torch.cat(sl_r)
        fe = torch.cat(sl_e)
        liveslot = fb >= 0
        n_slots = liveslot.sum()
        order = torch.where(liveslot, fb * G + fg, INT32_MAX)
        perm = torch.sort(order, stable=True).indices

        def cap(a, fill):
            a = a[perm][:js]
            return _pad_rows(a, js, fill)

        gs = torch.stack([cap(fg, 0), cap(fb, -1), cap(fr, 0),
                          cap(fe, 0)]).to(i32)
        n_overflow = (n_viol + torch.clamp(n_pairs - jp, min=0) * bs
                      + torch.clamp(n_slots - js, min=0) * bs)
    else:
        n_overflow = torch.where(jump, bs, 0).sum()
        gs = torch.zeros((4, 0), dtype=i32, device=dev)

    if exact_stats:
        n_overflow = _uncovered(x_keys, ocoords, ovalid, ky, kz, kx,
                                ctx["stride3"], ctx["pad3"], ctx["in_dims"],
                                span, bs, sb, gs).sum()
    return SpanPlan(
        sb=sb.to(i32), se=se.to(i32), emp=emp, gp=gp,
        n_overflow=n_overflow.to(i32), gs=gs,
        kernel3=ctx["kernel3"], stride3=ctx["stride3"], pad3=ctx["pad3"],
        in_dims=ctx["in_dims"], span=span, bs=bs, js=js, gwin=gwin, jp=jp,
    )


def uncovered_rows(x_keys, out_coords, out_valid, plan: SpanPlan):
    """(V,) bool: output rows with a (site, group) window row that neither
    the plan's main window nor its slots cover, so some of whose taps the
    conv leaves out (tools only; their count is
    ``make_span_plan(..., exact_stats=True).n_overflow``)."""
    V = out_coords.shape[0]
    Vp = -(-V // plan.bs) * plan.bs
    ky, kz = _group_offsets(plan.kernel3, x_keys.device)
    rows = _uncovered(
        x_keys, _pad_rows(out_coords.to(torch.int32), Vp, 0),
        _pad_rows(out_valid.to(torch.int32), Vp, 0), ky, kz,
        int(plan.kernel3[0]), plan.stride3, plan.pad3, plan.in_dims,
        plan.span, plan.bs, plan.sb, plan.gs)
    return rows.any(dim=0)[:V]


def _uncovered(x_keys, ocoords, ovalid, ky, kz, kx, stride3, pad3,
               in_dims, span, bs, sb, gs):
    """(G, Vp) bool: the (group, site) window rows that neither the main
    window nor the plan's slots cover."""
    X, Y, Z = in_dims
    sx, sy, sz = stride3
    px, py, pz = pad3
    dev = x_keys.device
    Vp = ocoords.shape[0]
    NB = Vp // bs
    G = sb.shape[0]
    Vin = x_keys.shape[0]
    E = (sb * 16 + span).to(torch.int64)  # (G, NB)
    if gs.shape[1]:
        g, b, r, _ = gs.to(torch.int64)
        ok = b >= 0
        flat = torch.where(ok, b.clamp(min=0) * G + g, G * NB)
        Ef = torch.cat([E.T.reshape(-1), torch.zeros(1, dtype=torch.int64,
                                                     device=dev)])
        Ef = Ef.scatter_reduce(0, flat, torch.where(ok, r * 16 + span, 0),
                               reduce="amax")
        E = Ef[:-1].reshape(NB, G).T
    kpad = torch.cat([x_keys.to(torch.int64),
                      torch.full((1,), INT32_MAX, dtype=torch.int64,
                                 device=dev)])
    blk = torch.arange(Vp, device=dev) // bs
    Kcov = kpad[E[:, blk].clamp(0, Vin)]  # (G, Vp)
    c = ocoords.to(torch.int64)
    iy = c[:, 1] * sy - py + ky[:, None]
    iz = c[:, 2] * sz - pz + kz[:, None]
    row_ok = (ovalid[None] > 0) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    q_all = (iz * Y + iy) * X + (c[:, 0] * sx - px)[None]
    pos_all = _bisect(x_keys, torch.where(row_ok, q_all, 0)).to(torch.int64)
    k_at_pos = kpad[pos_all.clamp(0, Vin)]
    start_at = (sb.to(torch.int64) * 16)[:, blk]
    start_viol = (pos_all < start_at) & (k_at_pos < q_all + kx)
    return row_ok & ((q_all + kx > Kcov) | start_viol)


# ------------------------------------------------------------ plan graphs
_CURRENT_GRAPHS = None  # the PlanGraphs whose step() is open
_PLAN_TENSORS = ("out_coords", "out_valid")  # a request's tensors


def _plan_inputs(x_keys, requests) -> list:
    """A plan's tensors: x_keys, then each request's out_coords and
    out_valid."""
    return [x_keys] + [r[k] for r in requests for k in _PLAN_TENSORS]


def _graphs_for(x_keys, requests):
    """The current :class:`PlanGraphs` where a plan over these inputs
    replays from it (CUDA tensors), else None. A vmapped input under a
    current one raises: a graph holds one stream's plan."""
    graphs = _CURRENT_GRAPHS
    if graphs is None:
        return None
    if any(torch._C._functorch.is_batchedtensor(t)
           for t in _plan_inputs(x_keys, requests)):
        raise ValueError("a vmapped span plan cannot replay a CUDA graph")
    return graphs if x_keys.is_cuda else None


class PlanGraphs:
    """CUDA graphs of one single-stream pipeline's span plans.

    A plan is integer glue with static shapes: hundreds of small kernels,
    which eager mode launches from the host one by one. Inside
    :meth:`step`, a plan builder given CUDA tensors (and not
    ``exact_stats``) instead replays a graph of the eager
    ``_make_span_plans``, captured the first time its key is seen: every
    static argument of its requests, each input's shape and dtype, and the
    key's occurrence within the step, so that two equal calls of one step
    hold outputs of their own. The first call runs the builder once on a
    side stream (lazy state, :func:`_group_offsets`), captures it, then
    replays.
    The plans are the outputs of the same kernels in the same order as the
    eager ones, so they equal them bit for bit.

    A replay copies the inputs into the graph's own and overwrites its
    outputs, which every plan the previous replay of that key returned
    holds: nothing of a plan may outlive the next step unless copied (the
    pipeline's outputs stack the plans' counters into a fresh tensor).
    Each graph has a memory pool of its own, since the graphs need not
    replay in the order they were captured in: the fixed-frame mode's
    recovery step first meets its keys after the other steps' graphs were
    captured, and replays its new graphs before theirs. In a shared pool a
    graph captured earlier could write its temporaries over a later
    graph's outputs. Counters: ``plan.captures``,
    ``plan.replays`` (:mod:`insmos_tpu_torch.obs`)."""

    def __init__(self):
        self._graphs = {}  # (key, occurrence) -> (graph, inputs, plans)
        self._seen = collections.Counter()  # key -> builds this step
        self._stream = None

    def __len__(self) -> int:
        return len(self._graphs)

    @contextlib.contextmanager
    def step(self):
        """The body is one pipeline step: plan builders replay from these
        graphs, and each key's occurrence counts from 0."""
        global _CURRENT_GRAPHS
        prev, _CURRENT_GRAPHS = _CURRENT_GRAPHS, self
        self._seen.clear()
        try:
            yield
        finally:
            _CURRENT_GRAPHS = prev

    def replay(self, x_keys, requests) -> list:
        """``_make_span_plans(x_keys, requests)`` from its graph."""
        inputs = _plan_inputs(x_keys, requests)
        key = (tuple(tuple(sorted((k, v) for k, v in r.items()
                                  if k not in _PLAN_TENSORS))
                     for r in requests),
               tuple((tuple(t.shape), t.dtype, t.device) for t in inputs))
        n = self._seen[key]
        self._seen[key] += 1
        entry = self._graphs.get((key, n))
        if entry is None:
            entry = self._graphs[(key, n)] = self._capture(inputs, requests)
        else:
            for dst, src in zip(entry[1], inputs):
                dst.copy_(src)
        entry[0].replay()
        obs.count("plan.replays")
        return list(entry[2])

    def _capture(self, inputs, requests):
        dev = inputs[0].device
        static = [t.clone() for t in inputs]
        reqs = [dict(r, out_coords=static[1 + 2 * i],
                     out_valid=static[2 + 2 * i])
                for i, r in enumerate(requests)]
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side, main = self._stream, torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            _make_span_plans(static[0], reqs)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            plans = _make_span_plans(static[0], reqs)
        obs.count("plan.captures")
        return graph, static, plans


# --------------------------------------------------------------------- op
def _prepare(feats_cat, weights, parts, plan, T_out):
    kx = int(plan.kernel3[0])
    G = len(_groups_yz(plan.kernel3))
    for w, pt in zip(weights, parts):
        assert w.shape[0] == kx * G * pt.kt, (w.shape, kx, G, pt.kt)
    TC = feats_cat.shape[1]
    TO = max(pt.out_off + T_out * pt.cout for pt in parts)
    dtype = torch.bfloat16 if weights[0].dtype == torch.bfloat16 else \
        torch.float32
    wg = fold_weights_parts(weights, parts, kx, G, T_out, dtype, TC, TO)
    return feats_cat.to(dtype).contiguous(), wg.contiguous()


def span_conv_apply(x_keys, x_feats, out_coords, out_valid, weight,
                    plan: SpanPlan, T: int, kt: int = 1,
                    T_out: int | None = None, t0_off: int = 0):
    """Single-part wrapper over span_conv_parts: x_feats (Vin, T*cin),
    weight (K, cin, cout). Returns (V, T_out*cout) float32."""
    if T_out is None:
        T_out = T
    cin, cout = weight.shape[1], weight.shape[2]
    part = ConvPart(cin, cout, T, kt, 0, 0, t0_off)
    return span_conv_parts(x_keys, x_feats, [weight], (part,), out_coords,
                           out_valid, plan, T_out)


def span_conv_parts(x_keys, feats_cat, weights, parts, out_coords, out_valid,
                    plan: SpanPlan, T_out: int):
    """Multi-part span conv with a precomputed plan. Returns (V, TO_tot)
    float32 through the op ``insmos::span_conv``: CUDA tensors run the CUDA
    kernel, CPU tensors the plain version; anything else raises. Under
    ``torch.func.vmap`` over slots the op's batching rule runs all slots in
    one kernel launch (see ``_span_conv_vmap``)."""
    feats, wg = _prepare(feats_cat, weights, parts, plan, T_out)
    return span_conv_op(x_keys, feats, wg, out_coords, out_valid, plan.sb,
                        plan.emp, plan.gp, plan.gs, _plan_geom(plan))


def span_conv_parts_plain(x_keys, feats_cat, weights, parts, out_coords,
                          out_valid, plan: SpanPlan, T_out: int):
    """span_conv_parts through the plain PyTorch version on any device
    (the CPU path, and the comparison the kernel is held against)."""
    feats, wg = _prepare(feats_cat, weights, parts, plan, T_out)
    return span_conv_core_plain(x_keys, feats, wg, out_coords, out_valid,
                                plan)


def _site_queries(ocoords, ovalid, plan, ky, kz):
    """Window base query q and in-grid flag per output row for offsets
    (ky, kz) (broadcast shapes)."""
    X, Y, Z = plan.in_dims
    sx, sy, sz = plan.stride3
    px, py, pz = plan.pad3
    c = ocoords.to(torch.int64)
    xbase = c[..., 0] * sx - px
    iy = c[..., 1] * sy - py + ky
    iz = c[..., 2] * sz - pz + kz
    row_ok = (ovalid > 0) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    return (iz * Y + iy) * X + xbase, xbase, row_ok


def _tap_table(x_keys, out_coords, out_valid, plan: SpanPlan, G: int,
               kx: int):
    """(pos, mult), each (G, Vp, kx): the input row (or -1) that every
    (group, padded output row, tap) matches by key over the whole key
    array, and how many of the block's windows hold it (main window of a
    live block and non-empty pair; slot windows at rows >= excl)."""
    X = plan.in_dims[0]
    bs, span = plan.bs, plan.span
    dev = x_keys.device
    Vin = x_keys.shape[0]
    V = out_coords.shape[0]
    NB = -(-V // bs)
    Vp = NB * bs
    ocoords = _pad_rows(out_coords.to(torch.int32), Vp, 0)
    ovalid = _pad_rows(out_valid.to(torch.int32), Vp, 0)
    live = ovalid.reshape(NB, bs).sum(dim=1) > 0
    blk = torch.arange(Vp, device=dev) // bs
    dvec = torch.arange(kx, device=dev)
    gp = plan.gp.to(torch.int64)
    keys64 = x_keys.to(torch.int64)

    def taps(rows_c, rows_v, ky, kz):
        """(..., kx) matched input row (or -1) per output row and tap."""
        q, xbase, row_ok = _site_queries(rows_c, rows_v, plan, ky, kz)
        xd = xbase[..., None] + dvec
        ok = row_ok[..., None] & (xd >= 0) & (xd < X)
        qd = q[..., None] + dvec
        pos = _bisect(x_keys, torch.where(ok, qd, -1)).to(torch.int64)
        hit = ok & (pos < Vin) & (keys64[pos.clamp(max=Vin - 1)] == qd)
        return torch.where(hit, pos, -1)

    # multiplicity of every (group, output row, tap): main window + slots
    pos_g = []
    mult = torch.zeros((G, Vp, kx), dtype=torch.float32, device=dev)
    for g in range(G):
        pos = taps(ocoords, ovalid, gp[g, 0], gp[g, 1])  # (Vp, kx)
        start = plan.sb[g].to(torch.int64)[blk][:, None] * 16
        keep_blk = (live & (plan.emp[g] == 0))[blk][:, None]
        mult[g] = (keep_blk & (pos >= start) & (pos < start + span)).float()
        pos_g.append(pos)
    pos = torch.stack(pos_g)
    if plan.gs.shape[1]:
        sg, sbk, sr, sexcl = plan.gs.to(torch.int64)
        ok_s = sbk >= 0
        rows = (sbk.clamp(min=0)[:, None] * bs
                + torch.arange(bs, device=dev)[None])  # (JS, bs)
        pos_s = pos[sg[:, None], rows]  # (JS, bs, kx)
        lo = torch.maximum(sr * 16, sexcl)[:, None, None]
        hi = (sr * 16 + span)[:, None, None]
        inw = (ok_s[:, None, None] & (pos_s >= 0) & (pos_s >= lo)
               & (pos_s < hi)).float()
        flat = (sg[:, None] * Vp + rows).reshape(-1)
        mult.view(G * Vp, kx).index_add_(0, flat, inw.reshape(-1, kx))
    return pos, mult


def span_conv_core_plain(x_keys, feats, wg, out_coords, out_valid,
                         plan: SpanPlan):
    """Plain PyTorch span conv on folded weights.

    x_keys (Vin,) int32 sorted; feats (Vin, TC); wg (G, kx*TC, TO) in the
    feature dtype. Each tap's input row is found by searchsorted over the
    whole key array and then accepted only inside the block's main window
    (live block, non-empty pair) or inside a slot window of the block at
    rows >= excl -- counted once per window that holds it, exactly as the
    TPU kernels sum over windows. Products are taken in float32 (exact for
    bf16 operands) and accumulated in float32."""
    kx = int(plan.kernel3[0])
    G = wg.shape[0]
    TC = feats.shape[1]
    TO = wg.shape[2]
    Vin = x_keys.shape[0]
    V = out_coords.shape[0]
    pos, mult = _tap_table(x_keys, out_coords, out_valid, plan, G, kx)
    Vp = pos.shape[1]
    out = torch.zeros((Vp, TO), dtype=torch.float32, device=feats.device)
    fpad = torch.cat([feats, feats.new_zeros((1, TC))]).float()
    for g in range(G):
        rows = torch.where(pos[g] >= 0, pos[g], Vin)
        a = fpad[rows] * mult[g][..., None]  # (Vp, kx, TC)
        out += a.reshape(Vp, kx * TC) @ wg[g].float()
    return out[:V]


def span_conv_work(x_keys, feats, wg, out_coords, out_valid,
                   plan: SpanPlan) -> dict:
    """The work one span conv needs on these inputs, and the least time the
    card could take for it (``kernels.bound``: NVIDIA H100 SXM, 989
    TFLOP/s dense bf16, 3.35 TB/s).

    ``matched``: (site, group, tap) triples whose input row lies in one of
    the block's windows; ``flops``: 2 x the non-zero weight entries of
    every matched tap (zero weights and unmatched taps need no work);
    ``bytes``: keys, features and weights read once, coordinates and valid
    flags (int32) read once, the float32 output written once;
    ``bound_ms`` the larger of flops over the peak rate and bytes over the
    memory rate, ``bound_by`` which of the two sets it."""
    kx = int(plan.kernel3[0])
    G, K, TO = wg.shape
    Vin, TC = feats.shape
    V = out_coords.shape[0]
    _, mult = _tap_table(x_keys, out_coords, out_valid, plan, G, kx)
    taps = (mult > 0).sum(dim=1).to(torch.int64)  # (G, kx)
    nnz = (wg.reshape(G, kx, TC, TO) != 0).sum(dim=(2, 3)).to(torch.int64)
    matched = int(taps.sum())
    flops = 2 * int((taps * nnz).sum())
    esize = feats.element_size()
    nbytes = (4 * Vin + esize * Vin * TC + wg.element_size() * G * K * TO
              + 4 * 4 * V + 4 * V * TO)
    return dict(matched=matched, flops=flops, bytes=nbytes,
                **bound(nbytes, flops))


# ----------------------------------------------------------------- kernel
class SpanConvKernels:
    """ctypes binding of csrc/span_conv.cu.

    One launch replaces both TPU kernels, for one stream or for all the
    slots of a pod step. The counter ``span_conv.launches``
    (:mod:`insmos_tpu_torch.obs`) counts the launches (each runs the main
    windows, span_conv.py::_kernel) and ``span_conv.slot_launches`` those
    that also ran coverage slots (the plan has slots:
    span_conv.py::_gw_kernel). Both move only where a kernel is
    launched, whichever of the two (bf16 on the tensor cores, float32 on
    the CUDA cores) the operands' type selects."""

    def __init__(self):
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ..kernels import load_library

            lib = load_library()
            ptr, i = ctypes.c_void_p, ctypes.c_int
            # 10 inputs, JS, slot_off, out, 18 geometry ints, S, the slot
            # strides, stream
            lib.span_conv_f32.argtypes = ([ptr] * 10 + [i, ptr, ptr]
                                          + [i] * 18 + [i, ptr, ptr])
            lib.span_conv_f32.restype = i
            # 10 inputs, JS, slot_off, out, 18 geometry ints, Kp, TOP,
            # nw8, ntiles, vec, S, the slot strides, stream
            lib.span_conv_mma.argtypes = ([ptr] * 10 + [i, ptr, ptr]
                                          + [i] * 24 + [ptr, ptr])
            lib.span_conv_mma.restype = i
            self._lib = lib
        return self._lib


SPAN_KERNELS = SpanConvKernels()


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


KX_MAX, BS_MAX, SPAN_MAX = 5, 128, 512  # limits of csrc/span_conv.cu
# the bf16 kernel: K chunk, padded-K limit, widest column tile and the
# tile widths (n8 column tiles per warp, N = 16 * nw8) it is built for
MMA_KC, MMA_KP_MAX, MMA_N_MAX = 32, 4096, 160
MMA_NW8 = (1, 2, 3, 4, 5, 6, 8, 10)


def mma_layout(wg):
    """The bf16 kernel's weight layout: (wp, nw8, ntiles).

    TO splits into ``ntiles`` equal column tiles of at most 160 columns
    (320 -> 2 x 160), each padded to N = 16 * nw8; wp (G, Kp, ntiles * N)
    is wg zero-padded to Kp (a multiple of the 32-deep K chunk) rows and
    ntiles * N columns."""
    G, K, TO = wg.shape
    ntiles = -(-TO // MMA_N_MAX)
    nw8 = next(n for n in MMA_NW8 if 16 * n * ntiles >= TO)
    Kp = -(-K // MMA_KC) * MMA_KC
    if Kp > MMA_KP_MAX:
        raise ValueError(f"folded weight rows {K} above {MMA_KP_MAX}")
    wp = wg.new_zeros((G, Kp, ntiles * 16 * nw8))
    wp[:, :K, :TO] = wg
    return wp, nw8, ntiles


def span_conv_core_cuda(x_keys, feats, wg, out_coords, out_valid,
                        plan: SpanPlan):
    """The CUDA kernel on folded weights (same contract as
    span_conv_core_plain), launched once on the current stream: bf16
    operands run the tensor-core kernel, float32 operands the CUDA-core
    kernel.

    With a leading slot axis of S on every per-slot operand (x_keys (S, Vin),
    feats (S, Vin, TC), out_coords (S, V, 3), out_valid (S, V), and the
    plan's sb, emp (S, G, NB) and gs (S, 4, JS)) one launch runs all S slots
    (grid z) with the one weight ``wg`` and the plan's shared ``gp``, and
    returns (S, V, TO): slot s equals the launch on slot s alone."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"span_conv_core_cuda needs CUDA tensors, got {dev}")
    batched = x_keys.dim() == 2
    sb, emp, gs = plan.sb, plan.emp, plan.gs
    if not batched:
        x_keys, feats, out_coords, out_valid, sb, emp, gs = (
            t.unsqueeze(0) for t in (x_keys, feats, out_coords, out_valid,
                                     sb, emp, gs))
    kx = int(plan.kernel3[0])
    G, K, TO = wg.shape
    S, Vin, TC = feats.shape
    V = out_coords.shape[1]
    bs, span = plan.bs, plan.span
    NB = -(-V // bs)
    if not (1 <= kx <= KX_MAX and 1 <= bs <= BS_MAX and 16 <= span <= SPAN_MAX):
        raise ValueError(f"unsupported geometry kx={kx} bs={bs} span={span}")
    if K != kx * TC:
        raise ValueError(f"folded weight rows {K} != kx*TC {kx * TC}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feats dtype {feats.dtype}")
    ocoords = out_coords.to(torch.int32).contiguous()
    ovalid = out_valid.to(torch.int32).contiguous()
    dead = (torch.nn.functional.pad(ovalid, (0, NB * bs - V)).reshape(
        S, NB, bs).sum(dim=2) == 0).to(torch.int32)
    x_keys, feats, sb, emp = (t.contiguous() for t in (x_keys, feats, sb, emp))
    _check(x_keys, "x_keys", torch.int32, (S, Vin), dev)
    _check(feats, "feats", feats.dtype, (S, Vin, TC), dev)
    _check(wg, "wg", feats.dtype, (G, kx * TC, TO), dev)
    _check(ocoords, "out_coords", torch.int32, (S, V, 3), dev)
    _check(sb, "sb", torch.int32, (S, G, NB), dev)
    _check(emp, "emp", torch.int32, (S, G, NB), dev)
    _check(plan.gp, "gp", torch.int32, (G, 2), dev)
    JS = gs.shape[2]
    gs_ptr = off_ptr = None
    if JS:
        gs = gs.contiguous()
        _check(gs, "gs", torch.int32, (S, 4, JS), dev)
        # CSR over the block-sorted slots: block b owns [off[b], off[b+1])
        blocks = torch.where(gs[:, 1] >= 0, gs[:, 1], NB).contiguous()
        slot_off = torch.searchsorted(
            blocks, torch.arange(NB + 1, dtype=torch.int32, device=dev
                                 ).expand(S, NB + 1).contiguous()
        ).to(torch.int32)
        gs_ptr, off_ptr = gs.data_ptr(), slot_off.data_ptr()
    out = torch.empty((S, V, TO), dtype=torch.float32, device=dev)
    # per-slot offsets in elements, in csrc/span_conv.cu's SlotStrides order
    strides = (ctypes.c_longlong * 11)(Vin, Vin * TC, 3 * V, V, G * NB,
                                       G * NB, NB, 0, 4 * JS, NB + 1, V * TO)
    X, Y, Z = plan.in_dims
    sx, sy, sz = plan.stride3
    px, py, pz = plan.pad3
    geom = (V, Vin, NB, bs, G, kx, TC, TO, span, X, Y, Z, sx, sy, sz, px, py,
            pz)
    plan_ptrs = (ocoords.data_ptr(), ovalid.data_ptr(), sb.data_ptr(),
                 emp.data_ptr(), dead.data_ptr(), plan.gp.data_ptr(),
                 gs_ptr, JS, off_ptr, out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = SPAN_KERNELS.lib()
    if feats.dtype == torch.bfloat16:
        wp, nw8, ntiles = mma_layout(wg)
        align = feats.data_ptr() % 16
        vec = 8 if TC % 8 == 0 and align == 0 else (
            2 if TC % 2 == 0 and align % 4 == 0 else 1)
        err = lib.span_conv_mma(
            x_keys.data_ptr(), feats.data_ptr(), wp.data_ptr(), *plan_ptrs,
            *geom, wp.shape[1], wp.shape[2], nw8, ntiles, vec, S,
            ctypes.addressof(strides), stream)
    else:
        err = lib.span_conv_f32(x_keys.data_ptr(), feats.data_ptr(),
                                wg.data_ptr(), *plan_ptrs, *geom, S,
                                ctypes.addressof(strides), stream)
    if err:
        raise RuntimeError(f"span_conv launch failed: CUDA error {err}")
    obs.count("span_conv.launches")
    if JS:
        obs.count("span_conv.slot_launches")
    return out if batched else out[0]


# -------------------------------------------------------------------- op
def _plan_geom(plan: SpanPlan) -> list[int]:
    """The plan's static geometry as the op's int list."""
    return [*plan.kernel3, *plan.stride3, *plan.pad3, *plan.in_dims,
            plan.span, plan.bs]


def _plan_of(sb, emp, gp, gs, geom) -> SpanPlan:
    """A plan from the op's operands (what the convs read of it)."""
    k3, s3, p3, d3 = (tuple(geom[i:i + 3]) for i in (0, 3, 6, 9))
    return SpanPlan(sb=sb, se=None, emp=emp, gp=gp, n_overflow=None, gs=gs,
                    kernel3=k3, stride3=s3, pad3=p3, in_dims=d3,
                    span=geom[12], bs=geom[13])


@torch.library.custom_op("insmos::span_conv", mutates_args=(),
                         device_types="cpu")
def span_conv_op(x_keys: torch.Tensor, feats: torch.Tensor, wg: torch.Tensor,
                 out_coords: torch.Tensor, out_valid: torch.Tensor,
                 sb: torch.Tensor, emp: torch.Tensor, gp: torch.Tensor,
                 gs: torch.Tensor, geom: list[int]) -> torch.Tensor:
    """The span conv on folded weights (span_conv_core_plain's contract,
    the plan given by its tensors and ``geom``, see _plan_geom): the plain
    version on the CPU, the CUDA kernel on the card."""
    return span_conv_core_plain(x_keys, feats, wg, out_coords, out_valid,
                                _plan_of(sb, emp, gp, gs, geom))


@span_conv_op.register_kernel("cuda")
def _span_conv_op_cuda(x_keys, feats, wg, out_coords, out_valid, sb, emp, gp,
                       gs, geom):
    return span_conv_core_cuda(x_keys, feats, wg, out_coords, out_valid,
                               _plan_of(sb, emp, gp, gs, geom))


@span_conv_op.register_vmap
def _span_conv_vmap(info, in_dims, x_keys, feats, wg, out_coords, out_valid,
                    sb, emp, gp, gs, geom):
    """The op over a slot axis: one kernel launch over all slots on the
    card (the folded weight and the group table shared, as the slots share
    the model), the plain version slot by slot on the CPU."""
    if in_dims[2] is not None or in_dims[7] is not None:
        raise ValueError("span_conv over slots needs one weight and group "
                         "table for all slots")
    S = info.batch_size

    def slots(t, d):
        return t.movedim(d, 0) if d is not None else t.expand(S, *t.shape)

    x_keys, feats, out_coords, out_valid, sb, emp, gs = (
        slots(t, d) for t, d in zip(
            (x_keys, feats, out_coords, out_valid, sb, emp, gs),
            (in_dims[i] for i in (0, 1, 3, 4, 5, 6, 8))))
    if feats.is_cuda:
        return span_conv_core_cuda(x_keys, feats, wg, out_coords, out_valid,
                                   _plan_of(sb, emp, gp, gs, geom)), 0
    return torch.stack([
        span_conv_core_plain(x_keys[s], feats[s], wg, out_coords[s],
                             out_valid[s], _plan_of(sb[s], emp[s], gp, gs[s],
                                                    geom))
        for s in range(S)]), 0
