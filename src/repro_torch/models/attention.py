"""GQA attention for the paged ticks, on torch tensors.

Port of the paged serving paths of ``repro/models/attention.py``:
``gqa_init``, ``gqa_qkv`` (``:406``), ``paged_scatter`` (``:108``) and
``packed_scatter`` (``:129``), ``gqa_init_paged_cache`` (``:222``,
unquantized pools only), ``_gqa_paged_qkv_scatter`` (``:244``), and the
kernel branches of ``gqa_paged_apply`` (``:268``, the padded (B, C)
layout), ``gqa_paged_dual`` (``:304``, the fused dual-branch decode) and
``gqa_packed_apply`` (``:338``, the token-packed layout).  Sliding windows
and logit softcaps (the reference's gather branches) and quantized KV pages
come in later slices of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L


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


def gqa_qkv(p, cfg, x, positions):
    """Project x (B, S, D) to q (B, S, H, Dh) and k, v (B, S, Hkv, Dh), with
    qk_norm and RoPE at ``positions`` (B, S)."""
    Dh = cfg.resolved_head_dim
    H, Hkv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    B, S = x.shape[:2]
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = L.norm_apply(p["qnorm"], q)
        k = L.norm_apply(p["knorm"], k)
    if cfg.rope and positions is not None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def gqa_init_paged_cache(cfg, num_pages, page_size, dtype, device,
                         kv_dtype=""):
    """K/V page pools (P, page, Hkv, Dh) in ``dtype``."""
    if kv_dtype:
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: quantized KV pages come with the "
            f"quantized-KV slice of the PyTorch port")
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _unsupported(cfg, window, cache):
    """Raise for the attention variants later slices of the port bring."""
    if cfg.attn_softcap or window:
        raise NotImplementedError(
            "sliding-window / softcapped attention (the reference's gather "
            "branch) comes in a later slice of the PyTorch port")
    if "k_scale" in cache:
        raise NotImplementedError(
            "quantized KV pages come with the quantized-KV slice of the "
            "PyTorch port")


def _gqa_paged_qkv_scatter(p, cfg, x, cache, block_tables, pos, n_valid):
    """Shared prologue of the sequential and dual-branch padded paths:
    project q/k/v at the chunk's positions and scatter k/v into the page
    pools in place.  Returns (q (B, C, H, Dh), positions (B, C)): one
    implementation, so the two paths cannot drift apart."""
    C = x.shape[1]
    page = cache["k"].shape[1]
    positions = pos[:, None] + torch.arange(C, device=pos.device)[None]
    q, k, v = gqa_qkv(p, cfg, x, positions)
    paged_scatter(cache["k"], k, block_tables, pos, n_valid, page)
    paged_scatter(cache["v"], v, block_tables, pos, n_valid, page)
    return q, positions


def gqa_paged_apply(p, cfg, x, cache, block_tables, pos, n_valid, *,
                    window=0):
    """Padded chunked tick against a paged cache.  x: (B, C, D) with C >= 1
    (C == 1 is a decode-only tick; C > 1 serves lanes at any phase through
    per-lane ``pos``/``n_valid``).  Scatters this tick's K/V into ``cache``
    in place, then runs the decode kernel (C == 1) or the chunk kernel.
    Returns (out (B, C, D), cache)."""
    _unsupported(cfg, window, cache)
    B, C = x.shape[:2]
    q, _ = _gqa_paged_qkv_scatter(p, cfg, x, cache, block_tables, pos,
                                  n_valid)
    if C == 1:
        o = ops.paged_decode_attention(q[:, 0], cache["k"], cache["v"],
                                       block_tables, pos + 1)[:, None]
    else:
        o = ops.paged_chunk_attention(q, cache["k"], cache["v"],
                                      block_tables, pos, n_valid)
    return o.reshape(B, C, -1) @ p["wo"].to(x.dtype), cache


def gqa_paged_dual(p, ffn, cfg, x, mlp_in, cache, block_tables, pos,
                   n_valid):
    """Dual-branch single-token padded tick: the paged attention and the
    dense FFN go down as one dispatch (``ops.dual_branch_decode``: the
    fused kernel on the card).  x: (B, 1, D) post-ln1 attention input;
    mlp_in: (B, 1, D) the block's MLP input, independent of this block's
    attention.  Returns (attn_out (B, 1, D), ffn_out (B, 1, D), cache)."""
    _unsupported(cfg, 0, cache)
    B, C = x.shape[:2]
    q, _ = _gqa_paged_qkv_scatter(p, cfg, x, cache, block_tables, pos,
                                  n_valid)
    o, y = ops.dual_branch_decode(q[:, 0], cache["k"], cache["v"],
                                  block_tables, pos + 1, mlp_in, ffn,
                                  kind=cfg.mlp)
    a = o[:, None].reshape(B, C, -1) @ p["wo"].to(x.dtype)
    return a, y, cache


def gqa_packed_apply(p, cfg, x, cache, block_tables, tok_slot, tok_pos, *,
                     window=0):
    """Token-packed ragged tick against a paged cache.  x: (1, T, D) flat
    packed tokens, token t of lane ``tok_slot[t]`` at ``tok_pos[t]``.
    Scatters this tick's K/V into ``cache`` in place, then runs the packed
    paged-attention kernel.  Returns (out (1, T, D), cache)."""
    _unsupported(cfg, window, cache)
    B, T = x.shape[:2]
    page = cache["k"].shape[1]
    positions = tok_pos.clamp(min=0)[None]                    # (1, T)
    q, k, v = gqa_qkv(p, cfg, x, positions)                   # (1, T, H, Dh)
    packed_scatter(cache["k"], k[0], block_tables, tok_slot, tok_pos, page)
    packed_scatter(cache["v"], v[0], block_tables, tok_slot, tok_pos, page)
    o = ops.paged_packed_attention(q[0].contiguous(), cache["k"], cache["v"],
                                   block_tables, tok_slot, tok_pos)
    return o.reshape(B, T, -1) @ p["wo"].to(x.dtype), cache
