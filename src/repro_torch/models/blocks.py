"""Transformer block honoring the FAL connection modes (core/fal.py), for
the paged ticks.

Port of the replicated paths of ``repro/models/blocks.py``: a block is
``x + MHA(ln1(x)) + FFN(mlp_input)`` with optional post-norms
(``:143-214``), in the token-packed and the padded (B, C) paged layouts,
and the dual-branch decode block ``_block_apply_dual`` (``:217-291``).  No
tensor or sequence parallelism, no MoE, MLA or cross-attention: those come
in later slices of the port.
"""
from __future__ import annotations

from repro_torch.core import fal
from repro_torch.core.plan import ExecutionPlan, Phase
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


def _paged_attention(p, cfg, h, cache, block_tables, pos, n_valid, tok_slot,
                     tok_pos, window):
    """The block's MHA over the paged cache in whichever layout the batch
    uses: token-packed when ``tok_slot`` is given, else padded (B, C)."""
    if tok_slot is not None:
        return A.gqa_packed_apply(p["attn"], cfg, h, cache, block_tables,
                                  tok_slot, tok_pos, window=window)
    return A.gqa_paged_apply(p["attn"], cfg, h, cache, block_tables, pos,
                             n_valid, window=window)


def block_apply(p, cfg, x, a1_sig, *, is_block0=False, plan=None, cache,
                block_tables, pos=None, n_valid=None, tok_slot=None,
                tok_pos=None, window=0):
    """One block over x: the packed buffer (1, T, D) with ``tok_slot`` /
    ``tok_pos``, or the padded (B, C, D) chunk with ``pos`` / ``n_valid``.
    Updates ``cache`` in place; returns (x_out, a_raw) where ``a_raw`` is
    this block's MHA output (block 0 exports it as the first-attention
    signal).  Under ``plan.dual_branch`` every block but block 0 runs the
    MHA || MLP branch-parallel block."""
    plan = ExecutionPlan.resolve(plan)
    if plan.dual_branch and not is_block0 \
            and plan.phase in (Phase.DECODE, Phase.PAGED):
        # steady-state MHA||MLP branch parallelism (plan.validate guarantees
        # a DUAL_BRANCH_MODES connection and no post-norms); block 0 stays
        # sequential: it must assemble its attention to export the signal
        return _block_apply_dual(p, cfg, x, a1_sig, window, plan=plan,
                                 cache=cache, pos=pos,
                                 block_tables=block_tables, n_valid=n_valid,
                                 tok_slot=tok_slot, tok_pos=tok_pos)
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    a, _ = _paged_attention(p, cfg, h, cache, block_tables, pos, n_valid,
                            tok_slot, tok_pos, window)
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


def _block_apply_dual(p, cfg, x, a1_sig, window, *, plan: ExecutionPlan,
                      cache, pos, block_tables, n_valid, tok_slot=None,
                      tok_pos=None):
    """Branch-parallel decode block: MHA || MLP (``plan.dual_branch``).

    For ``core.fal.DUAL_BRANCH_MODES`` the MLP input is a function of only
    the residual stream and the first-attention signal, never this block's
    own attention, so the branches share no data dependency:

        MLP branch : mlp_input(x, a1_sig) -> FFN
        MHA branch : ln1(x) -> qkv -> paged KV gather -> wo

    The MLP input is formed first.  On the padded C == 1 tick both branches
    go down as one fused dispatch (``attention.gqa_paged_dual``, the fused
    kernel on the card).  Otherwise the arithmetic is op for op the
    sequential path's (the packed kernel or the padded kernels, then the
    dense MLP), with the same ``(x + a) + y`` residual association, so the
    outputs are bit-identical.  In eager PyTorch those two branches run one
    after the other on one stream."""
    # a=None is safe: DUAL_BRANCH_MODES never read the block's own attention
    mlp_in = fal.mlp_input(cfg, p, x, None, a1_sig)
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    C = x.shape[1]
    if (plan.phase is Phase.PAGED and not cfg.use_mla and tok_slot is None
            and C == 1 and cfg.attn_softcap == 0.0 and window == 0):
        # single-token dense tick: fused dual-branch dispatch (padded layout
        # only: a packed buffer of length 1 is NOT a (B, 1) tick); the port
        # serves dense blocks only (models.model.check_supported)
        a, y, _ = A.gqa_paged_dual(p["attn"], p["ffn"], cfg, h, mlp_in,
                                   cache, block_tables, pos, n_valid)
    else:
        a, _ = _paged_attention(p, cfg, h, cache, block_tables, pos, n_valid,
                                tok_slot, tok_pos, window)
        y = L.mlp_apply(p["ffn"], mlp_in, cfg.mlp)
    # keep the sequential path's (x + a) + y association: bit-identical
    return (x + a) + y, a
