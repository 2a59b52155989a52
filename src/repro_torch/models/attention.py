"""GQA and MLA attention for training and the serving ticks, on torch
tensors.

Port of ``repro/models/attention.py``: ``blockwise_attention`` (``:21``,
the plain version of the flash-attention kernel) and the full-sequence
``gqa_apply`` (``:490``, through ``ops.flash_attention``) for training,
with ``_kv_group_slice`` (``:474``) for explicit TP with fewer KV heads
than ranks (also on the paged paths, given the plan); the contiguous
KV cache's ``gqa_init_cache`` (``:514``), ``decode_attention`` (``:69``,
``chunk_attention`` at one query a lane) and ``gqa_decode`` (``:522``);
and the paged serving paths: ``gqa_init``, ``gqa_qkv`` (``:406``),
``paged_scatter`` (``:108``) and
``packed_scatter`` (``:129``), ``paged_gather``, ``_gather_dequant`` and
``chunk_attention`` (``:149-190``), the quantized KV page format
(``KV_DTYPES``, ``_quant_rows``, ``:195-220``), ``gqa_init_paged_cache``
(``:222``), ``_gqa_paged_qkv_scatter`` (``:244``), ``gqa_paged_apply``
(``:268``, the padded (B, C) layout), ``gqa_paged_dual`` (``:304``, the fused
dual-branch decode, or its two-op route on quantized pages) and
``gqa_packed_apply`` (``:338``, the token-packed layout), and the whisper
decoder's ``gqa_cross_apply`` (``:505``).  DeepSeek-V3's
multi-head latent attention (``:538-714``): ``mla_init``, ``_mla_q`` /
``_mla_ckv`` (head count from the weights' width, so head shards work),
``mla_apply`` (full sequence through ``ops.flash_attention`` at qk width
dn + dr and v width dv), and the absorbed-matrix serving paths over the
latent cache (c, kr): ``mla_init_cache`` / ``mla_decode``,
``mla_init_paged_cache``, ``mla_paged_apply`` and ``mla_packed_apply``,
PyTorch ops as the reference's are jnp (no paged kernel reads latents).

The paged layouts have two branches, as in the reference: full attention
runs the block-table kernels; a layer with a sliding window or a logit
softcap (gemma2: every layer, the softcap is on in all of them) runs the
gather branch, which the reference writes in ``jnp`` and the port in
PyTorch ops: the pages gathered into each lane's logical sequence
(dequantized to fp32 on int8 / fp8 pages), fp32 scores, softcap, the
causal and window masks at -1e30, softmax in fp32, ``p`` in v's dtype for
P.V.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tp
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def blockwise_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                        block_q=512, scale=None, q_offset=0):
    """Flash-style attention over query blocks: q (B, Sq, H, Dh), k (B, Sk,
    Hkv, Dh), v (B, Sk, Hkv, Dv) -> (B, Sq, H, Dv) in v's dtype.  Scores in
    fp32 (O(block_q * Sk) of them at a time), softcapped, masked causally at
    the start (key j visible to query row i when j <= q_offset + i) and to
    ``window`` keys when window > 0, softmaxed in fp32; ``p`` is rounded to
    v's dtype before the P.V product, as in the reference."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    Dv = v.shape[-1]
    scale = Dh ** -0.5 if scale is None else scale
    bq = min(block_q, Sq)
    k_pos = torch.arange(Sk, device=q.device)
    kf = k.float()
    out = []
    for i0 in range(0, Sq, bq):
        qblk = q[:, i0:i0 + bq]
        n = qblk.shape[1]
        q_pos = q_offset + i0 + torch.arange(n, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk",
                         qblk.float().reshape(B, n, Hkv, G, Dh), kf) * scale
        s = L.softcap(s, cap)
        mask = torch.ones((n, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
        out.append(o.reshape(B, n, H, Dv))
    return torch.cat(out, dim=1)


def _kv_group_slice(k, v, cfg, plan):
    """Megatron's GQA fallback for ``n_kv_heads < tp`` inside the
    explicit-TP stack: wk / wv are replicated (``launch.mesh``), every rank
    computes all KV heads and keeps the one its query heads attend to
    (``tp / n_kv_heads`` ranks share each KV head)."""
    if plan is None or plan.tp_axis is None:
        return k, v
    tp = plan.tp_size
    if cfg.n_kv_heads % tp == 0:
        return k, v          # kv heads are sharded like query heads
    idx = plan.tp_rank // (tp // cfg.n_kv_heads)
    return k[:, :, idx:idx + 1], v[:, :, idx:idx + 1]


def gqa_apply(p, cfg, x, positions, *, window=0, causal=True, plan=None):
    """Full-sequence attention (train / eval / prefill): x (B, S, D) at
    ``positions`` (B, S) -> (B, S, D), through ``ops.flash_attention`` (the
    kernels on the card, ``blockwise_attention`` on the CPU).  With the
    explicit-TP shards of the weights (``plan.tp_axis`` set) the result is
    this rank's partial sum over its heads."""
    q, k, v = gqa_qkv(p, cfg, x, positions)
    k, v = _kv_group_slice(k, v, cfg, plan)
    B, S = x.shape[:2]
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            cap=cfg.attn_softcap, block_q=cfg.attn_block_q)
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def gqa_cross_apply(p, cfg, x, enc_out):
    """Cross-attention (the whisper decoder, reference ``:505-511``): x
    (B, Sq, D) attends to every row of ``enc_out`` (B, Sk, D), no mask, no
    rope, through ``ops.flash_attention(causal=False)``.  K / V are
    projected from ``enc_out`` at every call, as the reference keeps no
    cross-attention cache."""
    q, k, v = gqa_qkv(p, cfg, x, None, kv_x=enc_out, rope=False)
    o = ops.flash_attention(q, k, v, causal=False, cap=0.0,
                            block_q=cfg.attn_block_q)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def gqa_init(gen, cfg, dtype, device):
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    p = {
        "wq": L.dense_init(gen, d, H * Dh, dtype, device),
        "wk": L.dense_init(gen, d, Hkv * Dh, dtype, device),
        "wv": L.dense_init(gen, d, Hkv * Dh, dtype, device),
        "wo": L.dense_init(gen, H * Dh, d, dtype, device,
                           scale=1.0 / np.sqrt(H * Dh * 2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["qnorm"] = L.norm_init(Dh, "rmsnorm", device)
        p["knorm"] = L.norm_init(Dh, "rmsnorm", device)
    return p


def gqa_qkv(p, cfg, x, positions, kv_x=None, rope=True):
    """Project x (B, S, D) to q (B, S, H, Dh) and k, v (B, Skv, Hkv, Dh)
    from ``kv_x`` (B, Skv, D) (None: x), with qk_norm and, when ``rope``,
    RoPE at ``positions`` (B, S)."""
    Dh = cfg.resolved_head_dim
    H, Hkv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    B, S = x.shape[:2]
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (kv_x @ p["wk"].to(x.dtype)).reshape(B, Skv, Hkv, Dh)
    v = (kv_x @ p["wv"].to(x.dtype)).reshape(B, Skv, Hkv, Dh)
    if cfg.qk_norm:
        q = L.norm_apply(p["qnorm"], q)
        k = L.norm_apply(p["knorm"], k)
    if cfg.rope and rope and positions is not None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_init_cache(cfg, batch, seq, dtype, device, n_kv_heads=None):
    """Contiguous K/V cache: zeros of (batch, seq, Hkv, Dh) in ``dtype``;
    ``n_kv_heads`` the heads a rank holds under explicit TP
    (``core.plan.local_kv_heads``; None: all of ``cfg.n_kv_heads``)."""
    shape = (batch, seq, n_kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(q, k_cache, v_cache, pos, *, window=0, cap=0.0,
                     scale=None):
    """One-token attention against a contiguous cache: q (B, 1, H, Dh),
    caches (B, S, Hkv, D*), pos (B,) the index of the current token (keys
    at indices <= pos are visible, and with ``window`` > 0 only those
    > pos - window).  ``chunk_attention`` with one query a lane.  Returns
    (B, 1, H, Dv) in the cache's dtype."""
    return chunk_attention(q, k_cache, v_cache, pos[:, None], window=window,
                           cap=cap, scale=scale)


def gqa_decode(p, cfg, x, cache, pos, *, window=0, plan=None):
    """One-step decode: x (B, 1, D), pos (B,) each lane's position.  Writes
    lane b's k/v at row ``pos[b]`` of the cache in place (the reference's
    ``dynamic_update_slice``, which clamps the row into the cache), then
    attends.  Returns (out (B, 1, D), cache).  The attention output is in
    the cache's dtype and meets ``wo`` in the promoted dtype of the two, as
    the reference's ``o @ wo.astype(x.dtype)`` does.  Under explicit TP
    (``plan``) the cache holds this rank's KV heads and the output is its
    partial sum."""
    B = x.shape[0]
    q, k, v = gqa_qkv(p, cfg, x, pos[:, None])
    k, v = _kv_group_slice(k, v, cfg, plan)
    rows = pos.long().clamp(0, cache["k"].shape[1] - 1)
    lanes = torch.arange(B, device=x.device)
    cache["k"][lanes, rows] = k[:, 0].to(cache["k"].dtype)
    cache["v"][lanes, rows] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], pos, window=window,
                         cap=cfg.attn_softcap)
    dt = torch.promote_types(o.dtype, x.dtype)
    return o.reshape(B, 1, -1).to(dt) @ p["wo"].to(x.dtype).to(dt), cache


def paged_scatter(pages, vals, block_tables, pos, n_valid, page_size):
    """Write a (B, C, ...) chunk of per-token values into the page pool IN
    PLACE (``index_put_``; the reference returns a new pool) and return the
    pool.

    pages: (P, page_size, ...); vals: (B, C, ...); block_tables: (B, T);
    pos: (B,) logical position of each lane's first chunk token; n_valid:
    (B,) valid tokens in the chunk.  Rows past ``n_valid`` are redirected
    to the scratch page 0, so ragged chunks never corrupt live pages."""
    B, C = vals.shape[:2]
    T = block_tables.shape[1]
    lpos = (pos[:, None] + torch.arange(C, device=pos.device)[None]).long()
    blk = (lpos // page_size).clamp(0, T - 1)
    pg = torch.gather(block_tables, 1, blk).long()                # (B, C)
    valid = torch.arange(C, device=pos.device)[None] < n_valid[:, None]
    pg = torch.where(valid, pg, torch.zeros_like(pg))
    flat_idx = (pg * page_size + lpos % page_size).reshape(-1)
    flat = pages.view((pages.shape[0] * page_size,) + tuple(pages.shape[2:]))
    flat.index_put_((flat_idx,), vals.reshape(
        (B * C,) + tuple(vals.shape[2:])).to(pages.dtype))
    return pages


def packed_scatter(pages, vals, block_tables, tok_slot, tok_pos, page_size):
    """Write a flat (T, ...) packed token buffer into the page pool IN PLACE
    (``index_put_``; the reference returns a new pool) and return the pool.

    pages: (P, page_size, ...); vals: (T, ...); block_tables: (S, Tb);
    tok_slot/tok_pos: (T,).  Padding tokens (tok_pos == -1) are redirected
    to the scratch page 0, so ragged packs never corrupt live pages."""
    Tb = block_tables.shape[1]
    pos = tok_pos.clamp(min=0).long()
    blk = (pos // page_size).clamp(0, Tb - 1)
    pg = block_tables[tok_slot.long(), blk].long()
    pg = torch.where(tok_pos >= 0, pg, torch.zeros_like(pg))
    flat_idx = pg * page_size + pos % page_size
    flat = pages.view((pages.shape[0] * page_size,) + tuple(pages.shape[2:]))
    flat.index_put_((flat_idx,), vals.to(pages.dtype))
    return pages


#: quantized KV page storage (``EngineConfig.kv_dtype`` values); "" keeps
#: the engine's ``cache_dtype`` pools
KV_DTYPES = ("", "bf16", "int8", "fp8")
_KV_STORAGE = {"bf16": torch.bfloat16, "int8": torch.int8,
               "fp8": torch.float8_e4m3fn}


def _kv_qmax(pages_dtype) -> float:
    return 448.0 if pages_dtype == torch.float8_e4m3fn else 127.0


def _row_amax(vals):
    """vals (..., Hkv, Dh) -> each token row's fp32 amax over (Hkv, Dh)."""
    return vals.float().abs().amax(dim=(-2, -1))


def _quant_rows(vals, pages_dtype, amax=None):
    """Per-token-row KV quantization: vals (..., Hkv, Dh) -> (q, scale) with
    ``scale = amax / qmax`` over (Hkv, Dh), one fp32 scale per cached token
    row shared by the KV heads.  A row's scale depends on that row alone, so
    re-scattering a position, a COW page copy and a prefix-cache hit give
    the same bytes.  ``amax`` (...): the rows' amax when it is not this
    ``vals``' own (explicit TP: the max over every rank's heads).  ``q`` is
    in fp32 units of the narrow grid (the int8 grid rounded half to even
    and clipped); the page scatter's cast to the pool's dtype does the
    final rounding (fp8: to nearest even)."""
    qmax = _kv_qmax(pages_dtype)
    a = _row_amax(vals) if amax is None else amax
    scale = torch.clamp(a / qmax, min=1e-8)
    q = vals.float() / scale[..., None, None]
    if pages_dtype != torch.float8_e4m3fn:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q, scale


def gqa_init_paged_cache(cfg, num_pages, page_size, dtype, device,
                         kv_dtype="", n_kv_heads=None):
    """K/V page pools (P, page, Hkv, Dh); ``n_kv_heads`` the heads a rank
    holds under explicit TP (``core.plan.local_kv_heads``; None: all of
    ``cfg.n_kv_heads``).  ``kv_dtype``: "" stores in ``dtype`` (the
    engine's ``cache_dtype``); "bf16" stores bfloat16 with no scales;
    "int8" / "fp8" store int8 / float8_e4m3fn plus (P, page) fp32
    ``k_scale`` / ``v_scale`` row-scale pools (initialised to 1)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    store = _KV_STORAGE.get(kv_dtype, dtype)
    shape = (num_pages, page_size, n_kv_heads or cfg.n_kv_heads,
             cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape, dtype=store, device=device),
             "v": torch.zeros(shape, dtype=store, device=device)}
    if kv_dtype in ("int8", "fp8"):
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.ones((num_pages, page_size),
                                     dtype=torch.float32, device=device)
    return cache


def paged_gather(pages, block_tables):
    """(P, page, ...) x (B, T) -> (B, T * page, ...): each lane's logical
    sequence (gathered index == logical position)."""
    g = pages[block_tables.long()]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2])
                     + tuple(g.shape[3:]))


def _gather_dequant(pages, scale_pages, block_tables):
    """Gather a K/V pool to (B, Sk, Hkv, D) and, when a (P, page) row-scale
    pool rides along (int8 / fp8 pages), dequantize to fp32."""
    g = paged_gather(pages, block_tables)
    if scale_pages is None:
        return g
    s = paged_gather(scale_pages, block_tables)                # (B, Sk)
    return g.float() * s[..., None, None]


def chunk_attention(q, k, v, q_pos, *, window=0, cap=0.0, scale=None):
    """Multi-token attention against a gathered cache with per-token
    positions: q (B, C, H, Dh), k and v (B, Sk, Hkv, D*), q_pos (B, C) the
    position of each query.  Key j is visible iff j <= q_pos and, when
    window > 0, j > q_pos - window.  fp32 scores, softcapped, masked at
    -1e30, softmaxed in fp32; ``p`` in v's dtype for P.V.  Returns
    (B, C, H, Dv) in v's dtype."""
    B, C, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, C, Hkv, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    s = L.softcap(s, cap)
    k_pos = torch.arange(Sk, device=q.device)[None, None]          # (1,1,Sk)
    qp = q_pos[:, :, None]
    mask = k_pos <= qp
    if window > 0:
        mask = mask & (k_pos > qp - window)
    s = torch.where(mask[:, None, None], s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, C, H, v.shape[-1])


def _gathered(cfg, window) -> bool:
    """Whether a layer runs the gather branch: a sliding window or a logit
    softcap (the block-table kernels take neither)."""
    return cfg.attn_softcap != 0.0 or window != 0


def _scatter_kv(cache, k, v, scatter, plan=None):
    """Write k, v into the pools with ``scatter(pool, vals)``, quantizing
    each token row first when the cache carries scale pools.

    A row's scale is shared by all KV heads, so under explicit TP
    (``plan.tp_axis``), where this rank holds ``Hkv / tp`` of them, the
    rows' K and V amax go through ONE MAX all-reduce over the group
    (``core.tp.all_reduce``, a (rows, 2) fp32 tensor): every rank then
    quantizes its heads with the one-device scale, and the ranks' pools,
    gathered over heads, are the one-device pools."""
    if "k_scale" in cache:
        amax = torch.stack([_row_amax(k), _row_amax(v)], -1)
        if plan is not None and plan.tp_axis is not None:
            amax = tp.all_reduce(amax, plan.tp_axis, "forward",
                                 kind="all-reduce-max")
        k, ks = _quant_rows(k, cache["k"].dtype, amax[..., 0])
        v, vs = _quant_rows(v, cache["v"].dtype, amax[..., 1])
        scatter(cache["k_scale"], ks)
        scatter(cache["v_scale"], vs)
    scatter(cache["k"], k)
    scatter(cache["v"], v)


def _scales(cache):
    return {"k_scale": cache.get("k_scale"), "v_scale": cache.get("v_scale")}


def _gqa_paged_qkv_scatter(p, cfg, x, cache, block_tables, pos, n_valid,
                           plan=None):
    """Shared prologue of the sequential and dual-branch padded paths:
    project q/k/v at the chunk's positions and scatter k/v (and their row
    scales) into the page pools in place.  Returns (q (B, C, H, Dh),
    positions (B, C)): one implementation, so the two paths cannot drift
    apart."""
    C = x.shape[1]
    page = cache["k"].shape[1]
    positions = pos[:, None] + torch.arange(C, device=pos.device)[None]
    q, k, v = gqa_qkv(p, cfg, x, positions)
    k, v = _kv_group_slice(k, v, cfg, plan)
    _scatter_kv(cache, k, v, lambda pool, vals: paged_scatter(
        pool, vals, block_tables, pos, n_valid, page), plan)
    return q, positions


def gqa_paged_apply(p, cfg, x, cache, block_tables, pos, n_valid, *,
                    window=0, plan=None):
    """Padded chunked tick against a paged cache.  x: (B, C, D) with C >= 1
    (C == 1 is a decode-only tick; C > 1 serves lanes at any phase through
    per-lane ``pos``/``n_valid``).  Scatters this tick's K/V into ``cache``
    in place, then runs the decode kernel (C == 1) or the chunk kernel,
    their scale variants on quantized pages; a layer with a window or a
    softcap runs the gather branch (``chunk_attention`` over each lane's
    gathered, dequantized sequence; its output, in the pages' dtype or fp32
    on quantized pages, is cast to x's dtype, which is the reference's
    ``astype`` on quantized pages and its type promotion in the ``wo``
    product otherwise).  Returns (out (B, C, D), cache)."""
    B, C = x.shape[:2]
    q, positions = _gqa_paged_qkv_scatter(p, cfg, x, cache, block_tables,
                                          pos, n_valid, plan)
    ks, vs = cache.get("k_scale"), cache.get("v_scale")
    if _gathered(cfg, window):
        o = chunk_attention(q, _gather_dequant(cache["k"], ks, block_tables),
                            _gather_dequant(cache["v"], vs, block_tables),
                            positions, window=window, cap=cfg.attn_softcap)
        o = o.to(x.dtype)
    elif C == 1:
        o = ops.paged_decode_attention(q[:, 0], cache["k"], cache["v"],
                                       block_tables, pos + 1,
                                       **_scales(cache))[:, None]
    else:
        o = ops.paged_chunk_attention(q, cache["k"], cache["v"],
                                      block_tables, pos, n_valid,
                                      **_scales(cache))
    return o.reshape(B, C, -1) @ p["wo"].to(x.dtype), cache


def gqa_paged_dual(p, ffn, cfg, x, mlp_in, cache, block_tables, pos,
                   n_valid, plan=None):
    """Dual-branch single-token padded tick: the paged attention and the
    dense FFN go down as one dispatch (``ops.dual_branch_decode``: the
    fused kernel on the card).  On quantized pages the fused kernel has no
    dequantization, so, as in the reference (``attention.py:322-329``), the
    two branches go down as two ops: the decode kernel's scale variant and
    ``mlp_apply``.  x: (B, 1, D) post-ln1 attention input; mlp_in: (B, 1, D)
    the block's MLP input, independent of this block's attention.  Returns
    (attn_out (B, 1, D), ffn_out (B, 1, D), cache).  Full attention only:
    ``blocks._block_apply_dual`` takes this route when the layer has no
    window and no softcap."""
    B, C = x.shape[:2]
    q, _ = _gqa_paged_qkv_scatter(p, cfg, x, cache, block_tables, pos,
                                  n_valid, plan)
    if "k_scale" in cache:
        o = ops.paged_decode_attention(q[:, 0], cache["k"], cache["v"],
                                       block_tables, pos + 1,
                                       **_scales(cache))
        y = L.mlp_apply(ffn, mlp_in, cfg.mlp)
    else:
        o, y = ops.dual_branch_decode(q[:, 0], cache["k"], cache["v"],
                                      block_tables, pos + 1, mlp_in, ffn,
                                      kind=cfg.mlp)
    a = o[:, None].reshape(B, C, -1) @ p["wo"].to(x.dtype)
    return a, y, cache


def gqa_packed_apply(p, cfg, x, cache, block_tables, tok_slot, tok_pos, *,
                     window=0, plan=None):
    """Token-packed ragged tick against a paged cache.  x: (1, T, D) flat
    packed tokens, token t of lane ``tok_slot[t]`` at ``tok_pos[t]``.
    Scatters this tick's K/V (quantized rows and their scales on quantized
    pages) into ``cache`` in place, then runs the packed paged-attention
    kernel or its scale variant; a layer with a window or a softcap runs
    the gather branch (``_packed_gather_attention``).  Returns
    (out (1, T, D), cache)."""
    B, T = x.shape[:2]
    page = cache["k"].shape[1]
    positions = tok_pos.clamp(min=0)[None]                    # (1, T)
    q, k, v = gqa_qkv(p, cfg, x, positions)                   # (1, T, H, Dh)
    k, v = _kv_group_slice(k, v, cfg, plan)
    _scatter_kv(cache, k[0], v[0], lambda pool, vals: packed_scatter(
        pool, vals, block_tables, tok_slot, tok_pos, page), plan)
    if _gathered(cfg, window):
        o = _packed_gather_attention(q[0], cache, block_tables, tok_slot,
                                     tok_pos, window,
                                     cfg.attn_softcap).to(x.dtype)
    else:
        o = ops.paged_packed_attention(q[0].contiguous(), cache["k"],
                                       cache["v"], block_tables, tok_slot,
                                       tok_pos, **_scales(cache))
    return o.reshape(B, T, -1) @ p["wo"].to(x.dtype), cache


def _packed_gather_attention(q, cache, block_tables, tok_slot, tok_pos,
                             window, cap):
    """The packed layout's gather branch: q (T, H, D), token t attending
    over its slot's gathered sequence at ``tok_pos[t]`` -> (T, H, Dv).

    The reference gathers a (T, Sk, Hkv, D) copy of each pool (every
    token's slot sequence, ``[tok_slot]`` after the gather): at gemma2's
    width, 263 tokens and 6144 keys, 6.6 GB a pool and layer in bf16.
    Here the same rows are computed slot by slot: all T queries against
    one slot's gathered sequence, kept for the tokens of that slot.  A
    token's row is the reference's (the same scores, masks and softmax
    over the same keys); padding tokens (tok_pos == -1) get their slot's
    fully masked row, as in the reference.  The slot loop has no host
    sync; it costs S x the scores of one pass (S = slots), never a
    per-token copy of the pools."""
    ks, vs = cache.get("k_scale"), cache.get("v_scale")
    out = None
    for s in range(block_tables.shape[0]):
        bt = block_tables[s:s + 1]
        o = chunk_attention(q[None], _gather_dequant(cache["k"], ks, bt),
                            _gather_dequant(cache["v"], vs, bt),
                            tok_pos[None], window=window, cap=cap)[0]
        out = o if out is None else torch.where(
            (tok_slot == s)[:, None, None], o, out)
    return out


# ------------------------------------------------------------------------- #
# MLA (DeepSeek-V3 multi-head latent attention)
# ------------------------------------------------------------------------- #
def mla_init(gen, cfg, dtype, device):
    """MLA's weights at the reference's scales (``attention.py:538``):
    the query and KV down-projections with their RMSNorms, the rope key's
    shared projection, the per-head up-projections and ``wo``."""
    d, H = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "w_dq": L.dense_init(gen, d, rq, dtype, device),
        "q_norm": L.norm_init(rq, "rmsnorm", device),
        "w_uq": L.dense_init(gen, rq, H * (dn + dr), dtype, device),
        "w_dkv": L.dense_init(gen, d, rkv, dtype, device),
        "kv_norm": L.norm_init(rkv, "rmsnorm", device),
        "w_kr": L.dense_init(gen, d, dr, dtype, device),
        "w_uk": L.dense_init(gen, rkv, H * dn, dtype, device),
        "w_uv": L.dense_init(gen, rkv, H * dv, dtype, device),
        "wo": L.dense_init(gen, H * dv, d, dtype, device,
                           scale=1.0 / np.sqrt(H * dv * 2 * cfg.n_layers)),
    }


def _mla_q(p, cfg, x, positions):
    """x (B, S, D) -> (q_nope (B, S, H, dn), q_rope (B, S, H, dr)), RoPE at
    ``positions``.  The head count comes from ``w_uq``'s width, so a head
    shard under explicit TP works."""
    B, S = x.shape[:2]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    H = p["w_uq"].shape[-1] // (dn + dr)
    cq = L.norm_apply(p["q_norm"], x @ p["w_dq"].to(x.dtype))
    q = (cq @ p["w_uq"].to(x.dtype)).reshape(B, S, H, dn + dr)
    return q[..., :dn], L.apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_ckv(p, cfg, x, positions):
    """x (B, S, D) -> (the normalised latent c (B, S, rkv), the rope key
    shared by all heads kr (B, S, dr))."""
    c = L.norm_apply(p["kv_norm"], x @ p["w_dkv"].to(x.dtype))
    kr = x @ p["w_kr"].to(x.dtype)
    kr = L.apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, kr


def mla_apply(p, cfg, x, positions, plan=None):
    """Full-sequence MLA (train / eval / prefill, reference ``:578``): k and
    v expanded per head, then ``ops.flash_attention`` at qk width dn + dr
    and v width dv (the kernel pads v to the qk width on the card), scale
    (dn + dr)^-0.5.  The head count comes from the up-projections, so
    under explicit TP (head shards, ``wo`` by rows) the result is this
    rank's partial sum."""
    B, S = x.shape[:2]
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    H = p["w_uk"].shape[-1] // dn
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c, kr = _mla_ckv(p, cfg, x, positions)
    k_nope = (c @ p["w_uk"].to(x.dtype)).reshape(B, S, H, dn)
    v = (c @ p["w_uv"].to(x.dtype)).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)], -1)
    o = ops.flash_attention(q, k, v, causal=True, scale=(dn + dr) ** -0.5,
                            block_q=cfg.attn_block_q)
    return o.reshape(B, S, H * dv) @ p["wo"].to(x.dtype)


def mla_init_cache(cfg, batch, seq, dtype, device):
    """Contiguous latent cache: zeros of (batch, seq, rkv) for c and
    (batch, seq, dr) for the rope key."""
    return {"c": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, seq, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device)}


def _mla_absorbed(p, cfg, q_nope, q_rope, cc, krc, mask, x_dtype):
    """Attention in the latent space (the reference's absorbed matrices):
    q_nope (N, M, H, dn) and q_rope (N, M, H, dr), the M queries of each of
    N rows against that row's latent cache cc (N, Sk, rkv) and rope keys
    krc (N, Sk, dr); mask (N, M, Sk).  q_lat = q_nope W_uk^T per head in
    x's dtype; fp32 scores (the reference's ``preferred_element_type``),
    latent part plus rope part, scaled, masked at -1e30, softmaxed in fp32;
    p in the cache's dtype for P.cc; W_uv in the promoted dtype of the
    two.  Returns (N, M, H * dv)."""
    rkv, dn, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    N, M, H = q_nope.shape[:3]
    w_uk = p["w_uk"].to(x_dtype).reshape(rkv, H, dn)
    q_lat = torch.einsum("nmhd,rhd->nmhr", q_nope, w_uk)
    s = q_lat.reshape(N, M * H, rkv).float() @ cc.float().transpose(1, 2)
    s = s + q_rope.reshape(N, M * H, -1).float() @ krc.float().transpose(
        1, 2)
    s = s.reshape(N, M, H, -1) * (dn + cfg.qk_rope_head_dim) ** -0.5
    s = torch.where(mask[:, :, None, :], s,
                    torch.full((), -1e30, device=s.device))
    pattn = torch.softmax(s, dim=-1).to(cc.dtype)
    o_lat = (pattn.reshape(N, M * H, -1) @ cc).reshape(N, M, H, rkv)
    dt = torch.promote_types(o_lat.dtype, x_dtype)
    w_uv = p["w_uv"].to(x_dtype).reshape(rkv, H, dv).to(dt)
    o = torch.einsum("nmhr,rhd->nmhd", o_lat.to(dt), w_uv)
    return o.reshape(N, M, H * dv)


def mla_decode(p, cfg, x, cache, pos):
    """Absorbed-matrix MLA decode (reference ``:611``): x (B, 1, D), pos
    (B,).  Writes each lane's latent and rope key at row ``pos[b]`` of the
    contiguous cache in place (clamped into the cache, as
    ``dynamic_update_slice`` does), then attends in the latent space over
    keys <= pos.  Returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c, kr = _mla_ckv(p, cfg, x, positions)
    rows = pos.long().clamp(0, cache["c"].shape[1] - 1)
    lanes = torch.arange(B, device=x.device)
    cache["c"][lanes, rows] = c[:, 0].to(cache["c"].dtype)
    cache["kr"][lanes, rows] = kr[:, 0].to(cache["kr"].dtype)
    Sk = cache["c"].shape[1]
    mask = (torch.arange(Sk, device=x.device)[None] <= pos[:, None])
    o = _mla_absorbed(p, cfg, q_nope, q_rope, cache["c"], cache["kr"],
                      mask[:, None], x.dtype)                  # (B, 1, H dv)
    return o @ p["wo"].to(x.dtype).to(o.dtype), cache


def mla_init_paged_cache(cfg, num_pages, page_size, dtype, device):
    """Latent page pools: c (P, page, rkv) and kr (P, page, dr)."""
    return {"c": torch.zeros((num_pages, page_size, cfg.kv_lora_rank),
                             dtype=dtype, device=device),
            "kr": torch.zeros((num_pages, page_size, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device)}


def mla_paged_apply(p, cfg, x, cache, block_tables, pos, n_valid):
    """Padded chunked tick of absorbed-matrix MLA against the latent pages
    (reference ``:651``): x (B, C, D); each lane's chunk scattered into the
    pools in place (rows past ``n_valid`` to the scratch page), then every
    query attends over its lane's gathered sequence up to its position.
    PyTorch ops, as the reference's are jnp.  Returns (out (B, C, D),
    cache)."""
    C = x.shape[1]
    page = cache["c"].shape[1]
    positions = pos[:, None] + torch.arange(C, device=pos.device)[None]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c, kr = _mla_ckv(p, cfg, x, positions)
    paged_scatter(cache["c"], c, block_tables, pos, n_valid, page)
    paged_scatter(cache["kr"], kr, block_tables, pos, n_valid, page)
    cc = paged_gather(cache["c"], block_tables)               # (B, Sk, rkv)
    krc = paged_gather(cache["kr"], block_tables)
    mask = (torch.arange(cc.shape[1], device=x.device)[None, None]
            <= positions[:, :, None])
    o = _mla_absorbed(p, cfg, q_nope, q_rope, cc, krc, mask, x.dtype)
    return o @ p["wo"].to(x.dtype).to(o.dtype), cache


#: packed tokens whose gathered latent sequences are held at once
MLA_PACKED_CHUNK = 64


def mla_packed_apply(p, cfg, x, cache, block_tables, tok_slot, tok_pos):
    """Token-packed tick of absorbed-matrix MLA (reference ``:682``): x
    (1, T, D), token t of slot ``tok_slot[t]`` at ``tok_pos[t]`` (-1:
    padding, scattered to the scratch page).  Each token attends over its
    own slot's latent sequence up to its position.  The reference gathers
    every slot's sequence and then a (T, Sk, rkv) copy of it by token; here
    the slots are gathered once and indexed by ``tok_slot`` in chunks of
    ``MLA_PACKED_CHUNK`` tokens, so the per-token copy held at once is
    (64, Sk, rkv), not (T, Sk, rkv).  The same rows, scores and softmax:
    the function is the reference's.  Returns (out (1, T, D), cache)."""
    B, T = x.shape[:2]
    page = cache["c"].shape[1]
    positions = tok_pos.clamp(min=0)[None]                     # (1, T)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c, kr = _mla_ckv(p, cfg, x, positions)
    packed_scatter(cache["c"], c[0], block_tables, tok_slot, tok_pos, page)
    packed_scatter(cache["kr"], kr[0], block_tables, tok_slot, tok_pos,
                   page)
    cs = paged_gather(cache["c"], block_tables)                # (S, Sk, rkv)
    krs = paged_gather(cache["kr"], block_tables)
    k_pos = torch.arange(cs.shape[1], device=x.device)[None]
    out = []
    for t0 in range(0, T, MLA_PACKED_CHUNK):
        sl = slice(t0, t0 + MLA_PACKED_CHUNK)
        slot = tok_slot[sl].long()
        mask = (k_pos <= tok_pos[sl, None])[:, None]           # (t, 1, Sk)
        out.append(_mla_absorbed(p, cfg, q_nope[0, sl, None],
                                 q_rope[0, sl, None], cs[slot], krs[slot],
                                 mask, x.dtype)[:, 0])
    o = torch.cat(out, 0).reshape(B, T, -1)
    return o @ p["wo"].to(x.dtype).to(o.dtype), cache
