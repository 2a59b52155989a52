"""Transformer block honoring the FAL connection modes (core/fal.py), for
the token-packed paged phase.

Port of the replicated path of ``repro/models/blocks.py:143-214``: a block
is ``x + MHA(ln1(x)) + FFN(mlp_input)`` with optional post-norms.  No
tensor or sequence parallelism, no dual-branch dispatch, no MoE, MLA or
cross-attention: those come in later slices of the port.
"""
from __future__ import annotations

from repro_torch.core import fal
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def block_init(gen, cfg, dtype, device, *, is_block0=False):
    d = cfg.d_model
    p = {"ln1": L.norm_init(d, cfg.norm, device),
         "ln2": L.norm_init(d, cfg.norm, device),
         "attn": A.gqa_init(gen, cfg, dtype, device),
         "ffn": L.mlp_init(gen, d, cfg.dense_d_ff or cfg.d_ff, cfg.mlp, dtype,
                           device)}
    if cfg.connection in fal.NEEDS_LN_FAL and (
            not is_block0 or cfg.connection == "ablation1"):
        p["ln_fal"] = L.norm_init(d, cfg.norm, device)
    if is_block0 and cfg.connection == "fal":
        p["ln_a"] = L.norm_init(d, cfg.norm, device)
    if cfg.post_norms:
        p["post_attn"] = L.norm_init(d, cfg.norm, device)
        p["post_ffn"] = L.norm_init(d, cfg.norm, device)
    return p


def block_apply(p, cfg, x, a1_sig, *, is_block0=False, cache, block_tables,
                tok_slot, tok_pos, window=0):
    """One block over the packed buffer x (1, T, D).  Updates ``cache`` in
    place; returns (x_out, a_raw) where ``a_raw`` is this block's MHA
    output (block 0 exports it as the first-attention signal)."""
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    a, _ = A.gqa_packed_apply(p["attn"], cfg, h, cache, block_tables,
                              tok_slot, tok_pos, window=window)
    if cfg.post_norms:
        a = L.norm_apply(p["post_attn"], a, cfg.norm)
    resid = x + a
    if is_block0:
        mlp_in = fal.block0_mlp_input(cfg, p, x, a)
    else:
        mlp_in = fal.mlp_input(cfg, p, x, a, a1_sig)
    y = L.mlp_apply(p["ffn"], mlp_in, cfg.mlp)
    if cfg.post_norms:
        y = L.norm_apply(p["post_ffn"], y, cfg.norm)
    return resid + y, a
