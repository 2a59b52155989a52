"""GQA attention for the token-packed paged tick, on torch tensors.

Port of the packed serving path of ``repro/models/attention.py``:
``gqa_init``, ``gqa_qkv`` (``:406``), ``packed_scatter`` (``:129``),
``gqa_init_paged_cache`` (``:222``, unquantized pools only) and
``gqa_packed_apply`` (``:338``, the kernel branch).  Sliding windows and
logit softcaps (the reference's per-token gather branch) and quantized KV
pages come in later slices of the port.
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


def gqa_packed_apply(p, cfg, x, cache, block_tables, tok_slot, tok_pos, *,
                     window=0):
    """Token-packed ragged tick against a paged cache.  x: (1, T, D) flat
    packed tokens, token t of lane ``tok_slot[t]`` at ``tok_pos[t]``.
    Scatters this tick's K/V into ``cache`` in place, then runs the packed
    paged-attention kernel.  Returns (out (1, T, D), cache)."""
    if cfg.attn_softcap or window:
        raise NotImplementedError(
            "sliding-window / softcapped attention (the per-token gather "
            "branch) comes in a later slice of the PyTorch port")
    if "k_scale" in cache:
        raise NotImplementedError(
            "quantized KV pages come with the quantized-KV slice of the "
            "PyTorch port")
    B, T = x.shape[:2]
    page = cache["k"].shape[1]
    positions = tok_pos.clamp(min=0)[None]                    # (1, T)
    q, k, v = gqa_qkv(p, cfg, x, positions)                   # (1, T, H, Dh)
    packed_scatter(cache["k"], k[0], block_tables, tok_slot, tok_pos, page)
    packed_scatter(cache["v"], v[0], block_tables, tok_slot, tok_pos, page)
    o = ops.paged_packed_attention(q[0].contiguous(), cache["k"], cache["v"],
                                   block_tables, tok_slot, tok_pos)
    return o.reshape(B, T, -1) @ p["wo"].to(x.dtype), cache
