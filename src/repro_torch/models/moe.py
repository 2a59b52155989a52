"""Mixture-of-Experts FFN on torch tensors.

Port of ``repro/models/moe.py``: ``moe_init`` (``:35``), ``_capacity``
(``:52``), ``_route`` (``:59``, with the group-limited branch ``:65-74``
and the load-balance aux ``E * sum_e f_e * P_e``), ``_dispatch_indices``
(``:84``), ``_expert_ffn`` (``:94``), and four paths:

* ``moe_apply`` (``:104``): the capacity dispatch on one device (one-hot
  cumsum, scatter into an (E, C, d) buffer, batched expert products,
  gather).  The serving ticks and one-device training run it;
* ``moe_apply_partial`` (``:127``): this rank's experts only, inside the
  explicit-TP stack; the block's all-reduce completes the expert combine;
* ``moe_apply_sharded`` (``:170``) and ``moe_apply_shard_slot``
  (``:227``): expert parallelism over a ``torch.distributed`` process
  group, the counterpart of the reference's mesh ``model`` axis.  Each
  rank holds its token shard (b, S/M, d) and its E/M experts; tokens cross
  through ``core.tp.all_to_all``.  The reference reaches them from a GSPMD
  plan; the port has none, so a caller passes the group.

Routing is softmax top-k with renormalisation; tokens above an expert's
capacity ``C = max(4, ceil(T k / E cf))`` are dropped in token-major
order.  ``T`` counts every row of the call (padding rows of a packed tick
included), as in the reference.

Top-k ties: ``jax.lax.top_k`` returns equal values lowest index first;
``torch.topk`` promises no order.  ``_topk`` is a stable descending sort,
so equal router probabilities (frequent in bf16) pick the reference's
experts.

The expert products are batched ``torch.bmm`` over experts, as the
reference leaves its ``einsum`` to XLA: no Pallas kernel backs them.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import tp
from repro_torch.models import layers as L


# ------------------------------------------------------------------------- #
# init
# ------------------------------------------------------------------------- #
def moe_init(gen, cfg, dtype, device):
    """Router (d, E), experts ``wi`` / ``wg`` (E, d, f) and ``wo`` (E, f,
    d) at the reference's scales, and the optional ``shared`` swiglu MLP of
    width ``moe_d_ff * n_shared_experts``."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    p = {"router": normal((d, E), s_in), "wi": normal((E, d, f), s_in),
         "wg": normal((E, d, f), s_in), "wo": normal((E, f, d), s_out)}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, f * cfg.n_shared_experts, "swiglu",
                                 dtype, device)
    return p


#: the counts ``counting_drops`` collects, None outside it
_DROPS = None
#: the routing choices ``recording_routes`` collects, None outside it
_ROUTES = None


@contextlib.contextmanager
def counting_drops():
    """Within the block, ``moe_apply`` adds to the yielded dict's
    ``pairs`` (routed (token, expert) pairs, an int) and ``dropped`` (those
    over capacity, a 0-d tensor on the device: no sync while counting)."""
    global _DROPS
    _DROPS = {"pairs": 0, "dropped": 0}
    try:
        yield _DROPS
    finally:
        _DROPS = None


@contextlib.contextmanager
def recording_routes():
    """Within the block, every ``_route`` call appends (experts (T, k),
    the probabilities top-k chose from (T, E)) to the yielded list, in call
    order (layer order within a tick), detached, on their device."""
    global _ROUTES
    _ROUTES = []
    try:
        yield _ROUTES
    finally:
        _ROUTES = None


def _capacity(T, k, E, cf):
    return max(4, int(math.ceil(T * k / E * cf)))


# ------------------------------------------------------------------------- #
# routing and dispatch (shared by every path)
# ------------------------------------------------------------------------- #
def _topk(x, k):
    """The ``k`` largest entries along the last dim, largest first, equal
    values lowest index first (``jax.lax.top_k``'s order): a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg, x2d):
    """x2d (T, d) -> (weights (T, k) in x's dtype, experts (T, k), aux)."""
    logits = (x2d @ p["router"].to(x2d.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                   # (T, E)
    E = cfg.n_experts
    if cfg.route_groups:
        # group-limited routing: keep the top ``route_group_limit`` groups
        # of each token (a group's score: its two largest probabilities)
        G = cfg.route_groups
        pg = probs.reshape(-1, G, E // G)
        top2 = _topk(pg, min(2, E // G))[0].sum(-1)         # (T, G)
        gidx = _topk(top2, cfg.route_group_limit)[1]        # (T, L)
        gmask = torch.zeros_like(top2).scatter(1, gidx, 1.0)
        probs = (pg * gmask[:, :, None]).reshape(-1, E)
    w, e = _topk(probs, cfg.top_k)                          # (T, k)
    if _ROUTES is not None:
        _ROUTES.append((e.detach(), probs.detach()))
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    # load balance: the fraction routed to each expert times its mean prob
    f_e = F.one_hot(e, E).float().sum(1).mean(0)            # (E,)
    P_e = probs.mean(0)
    aux = E * (f_e * P_e).sum()
    return w.to(x2d.dtype), e, aux


def _dispatch_indices(e, k, E, C):
    """e (T, k) expert ids -> (e_flat, pos, valid), each (T k,), in
    token-major order: ``pos`` is the pair's slot in its expert's buffer
    (clamped to C - 1 where ``valid`` is False: the pair is dropped)."""
    ef = e.reshape(-1)
    onehot = F.one_hot(ef, E)                               # (N, E)
    cum = torch.cumsum(onehot, dim=0) - onehot              # exclusive
    pos = cum.gather(1, ef[:, None])[:, 0]
    valid = pos < C
    return ef, torch.where(valid, pos, C - 1), valid


def _expert_ffn(wi, wg, wo, xs):
    """xs (E_loc, C*, d); wi / wg (E_loc, d, f), wo (E_loc, f, d)."""
    h = F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wi)
    return torch.bmm(h, wo)


def _scatter_rows(n_exp, C, rows, ef, pos, keep):
    """An (n_exp, C, d) buffer with ``rows`` (N, d) added at (ef, pos)
    where ``keep``; the others add zero (every kept (ef, pos) is distinct,
    so the order of the additions does not matter)."""
    d = rows.shape[-1]
    buf = rows.new_zeros((n_exp, C, d))
    return buf.index_put((ef, pos), rows * keep[:, None].to(rows.dtype),
                         accumulate=True)


def _combine(out_buf, ef, pos, keep, w, T, k):
    """Each token's sum over its k pairs of the expert output times the
    routing weight; dropped pairs give zero."""
    d = out_buf.shape[-1]
    got = out_buf[ef, pos] * keep[:, None].to(out_buf.dtype)
    return (got.reshape(T, k, d) * w[..., None]).sum(1)


def _weights(p, dtype):
    return (p["wi"].to(dtype), p["wg"].to(dtype), p["wo"].to(dtype))


# ------------------------------------------------------------------------- #
# one device (serving ticks, one-device training, the oracle)
# ------------------------------------------------------------------------- #
def moe_apply(p, cfg, x):
    """x (B, S, d) -> (y, aux).  Inside ``counting_drops()`` the call adds
    its (token, expert) pairs and the dropped ones to the counts."""
    B, S, d = x.shape
    T, k, E = B * S, cfg.top_k, cfg.n_experts
    C = _capacity(T, k, E, cfg.capacity_factor)
    x2d = x.reshape(T, d)
    w, e, aux = _route(p, cfg, x2d)
    ef, pos, valid = _dispatch_indices(e, k, E, C)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = _scatter_rows(E, C, x2d[tok], ef, pos, valid)
    out_buf = _expert_ffn(*_weights(p, x.dtype), buf)
    y = _combine(out_buf, ef, pos, valid, w, T, k)
    if "shared" in p:
        y = y + L.mlp_apply(p["shared"], x2d, "swiglu")
    if _DROPS is not None:
        _DROPS["pairs"] += T * k
        _DROPS["dropped"] = _DROPS["dropped"] + (~valid).sum()
    return y.reshape(B, S, d), aux


# ------------------------------------------------------------------------- #
# explicit TP: this rank's experts, a partial sum
# ------------------------------------------------------------------------- #
def _once_over(aux, group):
    """``aux`` as it is, with its gradient divided by the group's size.

    Under explicit TP every rank routes the same tokens, so ``aux`` is the
    same on every rank, and every gradient that flows from it (into the
    router, and into the MoE input) is summed over the ranks afterwards:
    the router's by ``model.tp_sync_grads``, the input's by the backward
    all-reduce of the *f* it entered through.  Dividing each rank's share
    makes the sum count the aux term once, not tp times."""
    n = group.size()
    if n == 1:
        return aux
    return aux.detach() + (aux - aux.detach()) / n


def moe_apply_partial(p, cfg, x, group):
    """This rank's experts' partial sum, inside the explicit-TP stack.

    ``p`` holds this rank's shards: ``wi`` / ``wg`` / ``wo`` the rank's
    E/tp experts (``launch.mesh.shard_params`` splits them on dim 0), the
    router whole, the shared expert (if any) column / row split like a
    dense MLP.  Every rank routes every token with the whole router and
    computes only its own experts; pairs routed elsewhere add zero here.
    The sum over the group (the block's all-reduce) equals ``moe_apply``.
    x (B, S, d) replicated -> (y_partial, aux), aux equal on every rank
    (its gradient split over them: ``_once_over``)."""
    B, S, d = x.shape
    E, E_loc = cfg.n_experts, p["wi"].shape[0]
    T, k = B * S, cfg.top_k
    C = _capacity(T, k, E, cfg.capacity_factor)
    x2d = x.reshape(T, d)
    w, e, aux = _route(p, cfg, x2d)
    ef, pos, valid = _dispatch_indices(e, k, E, C)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    lo = group.rank() * E_loc if E_loc != E else 0
    mine = (ef >= lo) & (ef < lo + E_loc)
    ok = valid & mine
    ef_loc = torch.where(mine, ef - lo, 0)
    buf = _scatter_rows(E_loc, C, x2d[tok], ef_loc, pos, ok)
    out_buf = _expert_ffn(*_weights(p, x.dtype), buf)
    y = _combine(out_buf, ef_loc, pos, ok, w, T, k)
    if "shared" in p:
        # a TP shard of the shared expert: its output is a partial sum too
        y = y + L.mlp_apply(p["shared"], x2d, "swiglu")
    return y.reshape(B, S, d), _once_over(aux, group)


# ------------------------------------------------------------------------- #
# expert parallelism over a process group
# ------------------------------------------------------------------------- #
def fsdp_gathered(p, cfg, data_group):
    """A MoE FFN's params ``p`` (the router, this rank's experts, the
    shared expert) with their FSDP slices (``launch.mesh.fsdp_specs``: the
    experts' and the router's ``d``) gathered over ``data_group`` before
    dispatch (``core.tp.gather_fsdp``: one all-gather, its backward one
    reduce-scatter); ``p`` as given without a group.  Inside the model a
    MoE block's unit gathers them with the block's other leaves."""
    if data_group is None:
        return p
    from repro_torch.launch import mesh as MX
    i = cfg.first_dense_layers
    prefix = ("block0", "ffn") if i == 0 else ("blocks", i - 1, "ffn")
    return tp.gather_fsdp(p, MX.fsdp_cuts(cfg, 1, data_group.size(), prefix),
                          data_group)


def _ep_inputs(p, group):
    """The replicated leaves entered through *f*: their gradients, partial
    sums over each rank's tokens, come back summed over the group."""
    router = tp.enter(p["router"], group)
    shared = p.get("shared")
    if shared is not None:
        shared = {k: tp.enter(v, group) for k, v in shared.items()}
    return router, shared


def _mean_over(aux, group):
    """The group's mean of each rank's aux (the reference's ``pmean``);
    the gradient reaches each rank's aux divided by the group's size."""
    return tp.assemble(aux, group) / group.size()


def moe_apply_sharded(p, cfg, x, group, data_group=None):
    """Expert parallelism with two all-to-alls a call (reference ``:170``).

    ``x`` (b, S/M, d) is this rank's token shard, ``p["wi"]`` / ``"wg"`` /
    ``"wo"`` its E/M experts (rank r holds experts [r E/M, (r+1) E/M)), the
    router and the shared expert whole.  Each rank routes its tokens into
    an (E, C, d) buffer (C from its own token count), sends each expert
    owner its (E/M, C, d) rows, runs its experts over all sources' rows,
    and sends the outputs back.  Returns (y (b, S/M, d), aux): aux is the
    group's mean.  Equal to ``moe_apply`` over the whole batch only where
    no pair drops (capacity is per source shard).  With ``data_group``
    ``p`` holds FSDP slices over it, gathered first (``fsdp_gathered``)."""
    p = fsdp_gathered(p, cfg, data_group)
    M, E = group.size(), cfg.n_experts
    if E % M:
        raise ValueError(f"n_experts={E} is not divisible by {M} ranks")
    b, S, d = x.shape
    T, k, E_loc = b * S, cfg.top_k, E // M
    C = _capacity(T, k, E, cfg.capacity_factor)
    x2d = x.reshape(T, d)
    router, shared = _ep_inputs(p, group)
    w, e, aux = _route({"router": router}, cfg, x2d)
    ef, pos, valid = _dispatch_indices(e, k, E, C)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = _scatter_rows(E, C, x2d[tok], ef, pos, valid)
    # dispatch: (M dest, E_loc, C, d) -> all-to-all -> (M src, E_loc, C, d)
    buf = tp.all_to_all(buf.reshape(M, E_loc, C, d), group)
    xs = buf.transpose(0, 1).reshape(E_loc, M * C, d)
    ys = _expert_ffn(*_weights(p, x.dtype), xs)
    ys = ys.reshape(E_loc, M, C, d).transpose(0, 1)
    out_buf = tp.all_to_all(ys, group).reshape(E, C, d)
    y = _combine(out_buf, ef, pos, valid, w, T, k)
    if shared is not None:
        y = y + L.mlp_apply(shared, x2d, "swiglu")
    return y.reshape(b, S, d), _mean_over(aux, group)


def moe_apply_shard_slot(p, cfg, x, group, data_group=None):
    """Expert parallelism with one wire crossing per (token, destination
    rank) instead of one per (token, expert) (reference ``:227``).

    Group-limited routing (``cfg.route_groups`` aligned to the ranks,
    limit L) bounds each token to L destination ranks: tokens are packed
    into per-rank slots (M, Cs, d), exchanged once with their (local
    expert, weight) metadata, dispatched to the local experts on the
    receiving rank (capacity C2), weighted there, and the per-rank partial
    sums come back in a fourth all-to-all.  Shapes, the returned aux and
    ``data_group`` as ``moe_apply_sharded``'s; equal to ``moe_apply`` only
    where nothing drops."""
    p = fsdp_gathered(p, cfg, data_group)
    M, E = group.size(), cfg.n_experts
    if E % M:
        raise ValueError(f"n_experts={E} is not divisible by {M} ranks")
    Lim = cfg.route_group_limit if cfg.route_groups else min(cfg.top_k, M)
    b, S, d = x.shape
    T, k, E_loc = b * S, cfg.top_k, E // M
    dev, dt = x.device, x.dtype
    Cs = _capacity(T, Lim, M, cfg.capacity_factor)      # slots a dest rank
    x2d = x.reshape(T, d)
    router, shared = _ep_inputs(p, group)
    w, e, aux = _route({"router": router}, cfg, x2d)

    # the destination rank of each (token, k-slot), deduplicated per token
    dest = torch.div(e, E_loc, rounding_mode="floor")           # (T, k)
    need = torch.zeros((T, M), dtype=torch.long, device=dev)
    need = need.scatter(1, dest, 1)                             # (T, M)
    pos = torch.cumsum(need, dim=0) - need        # slot in dest's buffer
    valid = (pos < Cs) & (need > 0)
    # dropped slots land in an extra row Cs that is cut off afterwards
    pos_oob = torch.where(valid, pos, Cs)
    rank_idx = torch.arange(M, device=dev)[None].expand(T, M)
    tok_idx = torch.arange(T, device=dev)[:, None].expand(T, M)
    send = x2d.new_zeros((M, Cs + 1, d)).index_put(
        (rank_idx, pos_oob), x2d[tok_idx] * valid[..., None].to(dt),
        accumulate=True)[:, :Cs]
    recv = tp.all_to_all(send, group)                   # (M src, Cs, d)

    # metadata: each (token, k-slot)'s local expert and weight, packed alike
    le = e - dest * E_loc                                       # (T, k)
    kslot = torch.arange(k, device=dev)[None].expand(T, k)
    vslot = valid.gather(1, dest)                               # (T, k)
    pslot = torch.where(vslot, pos_oob.gather(1, dest), Cs)
    meta_e = torch.full((M, Cs + 1, k), -1, dtype=torch.long, device=dev)
    meta_e = meta_e.index_put((dest, pslot, kslot), le)[:, :Cs]
    meta_w = torch.zeros((M, Cs + 1, k), dtype=torch.float32, device=dev)
    meta_w = meta_w.index_put((dest, pslot, kslot), w.float())[:, :Cs]
    meta_e = tp.all_to_all(meta_e, group)
    meta_w = tp.all_to_all(meta_w, group)

    # second stage on the receiving rank: (M Cs) rows -> E_loc experts
    N = M * Cs
    xs = recv.reshape(N, d)
    ef = meta_e.reshape(N, k)
    wf = meta_w.reshape(N, k).to(dt)
    # every source sends ~T k / E rows an expert; N is mostly padding
    C2 = _capacity(M * T, k, E, cfg.capacity_factor) * 2
    live = ef.reshape(-1) >= 0
    ef_flat = torch.where(live, ef.reshape(-1), 0)
    onehot = F.one_hot(ef_flat, E_loc) * live[:, None]
    cum = torch.cumsum(onehot, dim=0) - onehot
    pos2 = cum.gather(1, ef_flat[:, None])[:, 0]
    ok2 = live & (pos2 < C2)
    pos2_oob = torch.where(ok2, pos2, C2)
    tok2 = torch.arange(N, device=dev).repeat_interleave(k)
    buf = _scatter_rows(E_loc, C2 + 1, xs[tok2], ef_flat, pos2_oob,
                        ok2)[:, :C2]
    out_buf = _expert_ffn(*_weights(p, dt), buf)
    pos2c = torch.where(ok2, pos2, C2 - 1)
    # the weighted partial sum of each received row, applied here
    y_tok = _combine(out_buf, ef_flat, pos2c, ok2, wf, N, k)
    y_back = tp.all_to_all(y_tok.reshape(M, Cs, d), group)     # (M, Cs, d)

    # each token sums its <= M ranks' partials
    pos_rd = torch.where(valid, pos, 0)
    parts = y_back[rank_idx, pos_rd]                            # (T, M, d)
    y = (parts * valid[..., None].to(dt)).sum(1)
    if shared is not None:
        y = y + L.mlp_apply(shared, x2d, "swiglu")
    return y.reshape(b, S, d), _mean_over(aux, group)
