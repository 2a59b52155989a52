"""Transformer block honoring the FAL connection modes (core/fal.py), for
training and the paged ticks.

Port of ``repro/models/blocks.py``: a block is ``x + MHA(ln1(x)) +
FFN(mlp_input)`` with optional post-norms (``:143-214``), over the full
sequence (train / eval / prefill, ``:170-173``), over the contiguous KV
cache one token at a time (``Phase.DECODE``, ``:162-167``), in the
token-packed and the padded (B, C) paged layouts, and the dual-branch
decode block ``_block_apply_dual`` (``:217-291``), and ``window_schedule``
(``:388-393``), each layer's sliding window.

Under explicit tensor parallelism (``plan.tp_axis`` set: the process group
of ``models/model.py::decoder_stack_tp``) the attention and FFN see this
rank's head / hidden shards and return partial sums, and this module owns
the paper's per-block collective structure (``block_apply_tp``): modes
whose MLP input needs the block's assembled attention
(``fal.attention_must_assemble``) pay two all-reduces, the others add the
MHA and MLP partials locally and pay ONE.  With
``plan.sequence_parallel`` the same fork runs in the Megatron-SP layout
(``_block_apply_sp``).  A block's FFN is a dense MLP or a MoE layer
(``kind``, ``models/moe.py``): ``_ffn_apply`` returns its output and the
MoE's load-balance aux, which every apply function carries out.  The
attention is GQA or, under ``cfg.use_mla``, DeepSeek-V3's latent attention
(``attention.mla_*``) on every path (``_attend`` / ``_cached_attention``);
MLA blocks take the unfused dual-branch route, as in the reference.  The
whisper decoder's blocks (``block_init(cross=True)``) add cross-attention
to the encoder's output after the residual (``:197-203``), and its
encoder's blocks attend bidirectionally (``causal=False``).  Neither has a
dual-branch or a sequence-parallel path.  Under explicit TP an encoder
block takes the decoders' paths, and a cross-attention block always
assembles (``_block_apply_cross_tp``): the cross-attention's query reads
``x + a``, and the MLP input reads the assembled cross-attention, so the
block pays three all-reduces under every connection.
"""
from __future__ import annotations

from repro_torch.core import fal
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan, Phase
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def block_init(gen, cfg, dtype, device, *, kind="dense", cross=False,
               is_block0=False):
    """kind: 'dense' (``cfg.mlp`` FFN of ``dense_d_ff or d_ff``) or 'moe'
    (``moe.moe_init``); ``cross`` adds the cross-attention ``xattn`` and
    its norm ``ln_x``."""
    d = cfg.d_model
    p = {"ln1": L.norm_init(d, cfg.norm, device),
         "ln2": L.norm_init(d, cfg.norm, device),
         "attn": (A.mla_init if cfg.use_mla else A.gqa_init)(
             gen, cfg, dtype, device)}
    if cross:
        p["ln_x"] = L.norm_init(d, cfg.norm, device)
        p["xattn"] = A.gqa_init(gen, cfg, dtype, device)
    if kind == "moe":
        p["ffn"] = M.moe_init(gen, cfg, dtype, device)
    else:
        p["ffn"] = L.mlp_init(gen, d, cfg.dense_d_ff or cfg.d_ff, cfg.mlp,
                              dtype, device)
    if cfg.connection in fal.NEEDS_LN_FAL and (
            not is_block0 or cfg.connection == "ablation1"):
        p["ln_fal"] = L.norm_init(d, cfg.norm, device)
    if is_block0 and cfg.connection == "fal":
        p["ln_a"] = L.norm_init(d, cfg.norm, device)
    if cfg.post_norms:
        p["post_attn"] = L.norm_init(d, cfg.norm, device)
        p["post_ffn"] = L.norm_init(d, cfg.norm, device)
    return p


def is_moe(p) -> bool:
    """Whether a block's (or a tree of its structure's) FFN is a MoE
    layer."""
    return "router" in p["ffn"]


def _ffn_apply(p, cfg, h, kind, plan):
    """-> (y, aux).  Under explicit TP (``plan.tp_axis``) ``y`` is a
    partial sum (dense: column-split wi / wg, row-split wo; MoE: this
    rank's experts, ``moe.moe_apply_partial``).  aux is None for a dense
    FFN (no zero tensor a block on the serving path)."""
    if kind == "moe":
        if plan.tp_axis is not None:
            return M.moe_apply_partial(p["ffn"], cfg, h, plan.tp_axis)
        return M.moe_apply(p["ffn"], cfg, h)
    return L.mlp_apply(p["ffn"], h, cfg.mlp), None


def add_aux(total, aux):
    """Sum of the blocks' aux terms, None standing for 0."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _attend(p, cfg, h, positions, window, plan=None, causal=True):
    """The block's full-sequence MHA: GQA or MLA (reference ``:170-173``),
    over this rank's head shard under explicit TP; ``causal=False`` for
    the whisper encoder."""
    if cfg.use_mla:
        return A.mla_apply(p["attn"], cfg, h, positions, plan=plan)
    return A.gqa_apply(p["attn"], cfg, h, positions, window=window,
                       causal=causal, plan=plan)


def _cached_attention(p, cfg, h, cache, block_tables, pos, n_valid,
                      tok_slot, tok_pos, window, plan):
    """The block's MHA over its KV cache: the contiguous cache's one-token
    step under ``Phase.DECODE``, else the paged cache in whichever layout
    the batch uses: token-packed when ``tok_slot`` is given, else padded
    (B, C).  MLA (reference ``:147-168``) runs its absorbed-matrix paths
    over the latent caches."""
    if cfg.use_mla:
        if plan.phase is Phase.DECODE:
            return A.mla_decode(p["attn"], cfg, h, cache, pos, plan=plan)
        if tok_slot is not None:
            return A.mla_packed_apply(p["attn"], cfg, h, cache,
                                      block_tables, tok_slot, tok_pos)
        return A.mla_paged_apply(p["attn"], cfg, h, cache, block_tables,
                                 pos, n_valid)
    if plan.phase is Phase.DECODE:
        return A.gqa_decode(p["attn"], cfg, h, cache, pos, window=window,
                            plan=plan)
    if tok_slot is not None:
        return A.gqa_packed_apply(p["attn"], cfg, h, cache, block_tables,
                                  tok_slot, tok_pos, window=window, plan=plan)
    return A.gqa_paged_apply(p["attn"], cfg, h, cache, block_tables, pos,
                             n_valid, window=window, plan=plan)


def block_apply(p, cfg, x, a1_sig, *, kind="dense", is_block0=False,
                plan=None, cache=None, block_tables=None, pos=None,
                n_valid=None, tok_slot=None, tok_pos=None, window=0,
                positions=None, enc_out=None, causal=True):
    """One block over x: the full sequence (B, S, D) at ``positions`` (B, S)
    when ``plan`` is a full-sequence phase (train / eval / prefill; no
    cache); under ``Phase.DECODE`` one token a lane (B, 1, D) at ``pos``
    against the contiguous cache; else the packed buffer (1, T, D) with
    ``tok_slot`` / ``tok_pos`` or the padded (B, C, D) chunk with ``pos`` /
    ``n_valid``; ``cache`` is updated in place.  Returns (x_out, a_raw,
    aux) where ``a_raw`` is this block's MHA output (block 0 exports it as
    the first-attention signal) and ``aux`` the MoE load-balance term
    (None for a dense FFN).  ``kind``: the FFN, 'dense' or 'moe'.
    A block with cross-attention (``xattn``) attends to ``enc_out`` (B,
    F, D) after its self-attention; ``causal=False`` makes the
    full-sequence self-attention bidirectional (the whisper encoder).
    Under ``plan.dual_branch`` every block but block 0 runs the MHA || MLP
    branch-parallel block; under explicit TP (``plan.tp_axis``) the block is
    ``block_apply_tp``'s."""
    plan = ExecutionPlan.resolve(plan)
    if plan.dual_branch and not is_block0 \
            and plan.phase in (Phase.DECODE, Phase.PAGED):
        # steady-state MHA||MLP branch parallelism (plan.validate guarantees
        # a DUAL_BRANCH_MODES connection and no post-norms); block 0 stays
        # sequential: it must assemble its attention to export the signal
        if "xattn" in p:
            raise NotImplementedError(
                "dual-branch decode supports self-attention decoder blocks "
                "only (cross-attention consumes the assembled attention)")
        return _block_apply_dual(p, cfg, x, a1_sig, window, kind=kind,
                                 plan=plan, cache=cache, pos=pos,
                                 block_tables=block_tables, n_valid=n_valid,
                                 tok_slot=tok_slot, tok_pos=tok_pos)
    if plan.tp_axis is not None:
        x, a, _, aux = block_apply_tp(
            p, cfg, x, a1_sig, kind=kind, is_block0=is_block0, plan=plan,
            cache=cache, block_tables=block_tables, pos=pos, n_valid=n_valid,
            tok_slot=tok_slot, tok_pos=tok_pos, window=window,
            positions=positions, enc_out=enc_out, causal=causal)
        return x, a, aux
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    if plan.full_sequence:
        a = _attend(p, cfg, h, positions, window, causal=causal)
    else:
        a, _ = _cached_attention(p, cfg, h, cache, block_tables, pos,
                                 n_valid, tok_slot, tok_pos, window, plan)
    if cfg.post_norms:
        a = L.norm_apply(p["post_attn"], a, cfg.norm)
    resid = x + a
    if "xattn" in p:
        # the whisper decoder's cross-attention: it joins the residual and
        # x, so the FAL MLP input sees it but not this block's attention
        cx = A.gqa_cross_apply(p["xattn"], cfg,
                               L.norm_apply(p["ln_x"], resid, cfg.norm),
                               enc_out, plan)
        resid = resid + cx
        x = x + cx
    if is_block0:
        mlp_in = fal.block0_mlp_input(cfg, p, x, a)
    else:
        mlp_in = fal.mlp_input(cfg, p, x, a, a1_sig)
    y, aux = _ffn_apply(p, cfg, mlp_in, kind, plan)
    if cfg.post_norms:
        y = L.norm_apply(p["post_ffn"], y, cfg.norm)
    return resid + y, a, aux


def _block_apply_dual(p, cfg, x, a1_sig, window, *, kind,
                      plan: ExecutionPlan, cache, pos, block_tables, n_valid,
                      tok_slot=None, tok_pos=None):
    """Branch-parallel decode block: MHA || MLP (``plan.dual_branch``).

    For ``core.fal.DUAL_BRANCH_MODES`` the MLP input is a function of only
    the residual stream and the first-attention signal, never this block's
    own attention, so the branches share no data dependency:

        MLP branch : mlp_input(x, a1_sig) -> FFN
        MHA branch : ln1(x) -> qkv -> paged KV gather -> wo

    The MLP input is formed first.  On the padded C == 1 tick both branches
    go down as one fused dispatch (``attention.gqa_paged_dual``, the fused
    kernel on the card) when the FFN is dense; a MoE block's FFN is no
    swiglu matmul pair, so it takes the unfused route, as in the reference
    (``kind == "dense"``).  Otherwise the arithmetic is op for op the
    sequential path's (the packed kernel, the padded kernels or the
    contiguous cache's ``gqa_decode``, then the dense MLP), with the same
    ``(x + a) + y`` residual association, so the outputs are bit-identical.
    In eager PyTorch those two branches run one after the other on one
    stream.  Under explicit TP the two partial sums
    merge before the sequential fused path's one all-reduce: no extra
    collective (``core.tp.assert_dual_no_extra_collectives``)."""
    # a=None is safe: DUAL_BRANCH_MODES never read the block's own attention
    group = plan.tp_axis
    mlp_in = fal.mlp_input(cfg, p, x, None, a1_sig)
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    C = x.shape[1]
    if (plan.phase is Phase.PAGED and kind == "dense" and not cfg.use_mla
            and tok_slot is None and C == 1 and cfg.attn_softcap == 0.0
            and window == 0):
        # single-token dense tick: fused dual-branch dispatch (padded layout
        # only: a packed buffer of length 1 is NOT a (B, 1) tick)
        a, y, _ = A.gqa_paged_dual(p["attn"], p["ffn"], cfg, h, mlp_in,
                                   cache, block_tables, pos, n_valid,
                                   plan=plan)
        aux = None
    else:
        a, _ = _cached_attention(p, cfg, h, cache, block_tables, pos,
                                 n_valid, tok_slot, tok_pos, window, plan)
        y, aux = _ffn_apply(p, cfg, mlp_in, kind, plan)
    if group is not None:
        # one fused collective per block, as on the sequential fused path
        return x + tp.assemble(a + y, group), a, aux
    # keep the sequential path's (x + a) + y association: bit-identical
    return (x + a) + y, a, aux


def _fused(cfg, is_block0) -> bool:
    """Whether a TP block adds its MHA and MLP partials locally before one
    reduction: the MLP input must not need the block's assembled attention
    (``fal.attention_must_assemble``), and post-norms normalise that
    attention.  (A cross-attention block never does:
    ``_block_apply_cross_tp``.)"""
    return not cfg.post_norms and not fal.attention_must_assemble(
        cfg.connection, is_block0)


def _shared_signal(cfg) -> bool:
    """Under explicit TP FAL's signal enters every later block's sharded MLP
    through one *f* on the export (``tp.enter``) when those blocks take the
    fused path; with post-norms they assemble and their MLP inputs enter
    whole instead, as in a stack of cross-attention blocks."""
    return cfg.connection == "fal" and not cfg.post_norms


def block_apply_tp(p, cfg, x, a1_sig, *, kind="dense", is_block0=False,
                   plan, cache=None, block_tables=None, pos=None,
                   n_valid=None, tok_slot=None, tok_pos=None, window=0,
                   positions=None, enc_out=None, causal=True):
    """One block under explicit TP (reference ``:174-214``) over this
    rank's weight shards -> (x_out, a_raw, a1_export, aux).  A MoE FFN
    holds this rank's experts (``moe.moe_apply_partial``): its partial sum
    joins the block's all-reduce like a dense FFN's.  ``a1_export`` is
    block 0's first-attention signal as later blocks take it (FAL: the
    normalised export behind its one *f*; FAL+: the raw assembled
    attention; else None); later blocks return None there.

    Fused path (the MLP input does not need this block's attention: fal and
    ablation2 after block 0, parallel everywhere): x enters both branches
    through one *f*, and ``x + assemble(a + y)`` pays ONE all-reduce in the
    forward and one in the backward.  Assembled path: the attention
    partial is all-reduced, then the FFN partial (two), the LN outputs
    entering each sharded branch behind an *f* (two in the backward).
    FAL's block 0 assembles its attention and exports ``ln_a(a)``; with the
    fused path downstream, x enters through one *f* and the signal through
    the other, which also serves every later block: (L + 1) all-reduces
    each way over L layers.  ``a_raw`` is a partial sum on the fused path.
    Under ``plan.sequence_parallel`` x is this rank's sequence shard
    (``_block_apply_sp``).  Under ``plan.grad_compress`` each *f*'s
    backward all-reduce runs the compressed exchange
    (``optim/grad_compress.py``).  ``causal=False`` (the whisper encoder)
    attends bidirectionally on the same paths; a block with
    cross-attention takes ``_block_apply_cross_tp``."""
    group, gc = plan.tp_axis, plan.grad_compress
    if plan.sequence_parallel:
        if "xattn" in p or not causal:
            # the reference's SP refusal (``:131-139``)
            raise NotImplementedError(
                "sequence-parallel blocks support causal self-attention "
                "only (no cross-attention / bidirectional encoders)")
        return _block_apply_sp(p, cfg, x, a1_sig, positions, window,
                               kind=kind, is_block0=is_block0, plan=plan)

    def attend(h):
        if plan.full_sequence:
            return _attend(p, cfg, h, positions, window, plan, causal)
        return _cached_attention(p, cfg, h, cache, block_tables, pos,
                                 n_valid, tok_slot, tok_pos, window, plan)[0]

    def ffn(h):
        return _ffn_apply(p, cfg, h, kind, plan)

    if "xattn" in p:
        return _block_apply_cross_tp(p, cfg, x, a1_sig, attend, ffn,
                                     enc_out, is_block0=is_block0, plan=plan)

    if _fused(cfg, is_block0):
        x_in = tp.enter(x, group, gc)
        a = attend(L.norm_apply(p["ln1"], x_in, cfg.norm))
        mlp_in = (fal.block0_mlp_input(cfg, p, x_in, a) if is_block0
                  else fal.mlp_input(cfg, p, x_in, a, a1_sig))
        y, aux = ffn(mlp_in)
        return x + tp.assemble(a + y, group), a, None, aux

    if is_block0 and _shared_signal(cfg):
        x_in = tp.enter(x, group, gc)
        a = tp.assemble(attend(L.norm_apply(p["ln1"], x_in, cfg.norm)),
                        group)
        sig = tp.enter(fal.first_attention_signal(cfg, p, a), group, gc)
        # block 0's MLP input ln2(x) + ln_a(a) is fal's later-block input
        # over the exported signal
        y, aux = ffn(fal.mlp_input(cfg, p, x_in, a, sig))
        return (x + a) + tp.assemble(y, group), a, sig, aux

    h = tp.enter(L.norm_apply(p["ln1"], x, cfg.norm), group, gc)
    a = tp.assemble(attend(h), group)
    if cfg.post_norms:
        a = L.norm_apply(p["post_attn"], a, cfg.norm)
    mlp_in = (fal.block0_mlp_input(cfg, p, x, a) if is_block0
              else fal.mlp_input(cfg, p, x, a, a1_sig))
    y, aux = ffn(tp.enter(mlp_in, group, gc))
    y = tp.assemble(y, group)
    if cfg.post_norms:
        y = L.norm_apply(p["post_ffn"], y, cfg.norm)
    sig = fal.first_attention_signal(cfg, p, a) if is_block0 else None
    return (x + a) + y, a, sig, aux


def _block_apply_cross_tp(p, cfg, x, a1_sig, attend, ffn, enc_out, *,
                          is_block0, plan):
    """A whisper decoder block under explicit TP -> (x_out, a_raw,
    a1_export, aux).  Its cross-attention's query reads ``ln_x(x + a)``,
    so the self-attention is assembled first (all-reduce 1); the
    cross-attention's column-split heads over ``enc_out`` (which the model
    enters once through an *f*, ``tp.enter``, so that its backward
    all-reduce returns the encoder's whole gradient) give a row-split
    ``wo`` partial, assembled before the MLP input ``ln2(x + cx) (+
    a1_sig)`` is formed (2), then the FFN partial (3).  Three all-reduces
    under every connection; each sharded branch's input (``ln1(x)``,
    ``ln_x(x + a)``, the MLP input) enters behind its own *f*, so no
    replicated leaf's gradient is partial.  FAL's block 0 exports
    ``ln_a(a)`` whole: the later blocks' MLP inputs enter whole too."""
    group, gc = plan.tp_axis, plan.grad_compress
    a = tp.assemble(attend(tp.enter(L.norm_apply(p["ln1"], x, cfg.norm),
                                    group, gc)), group)
    if cfg.post_norms:
        a = L.norm_apply(p["post_attn"], a, cfg.norm)
    resid = x + a
    q_in = tp.enter(L.norm_apply(p["ln_x"], resid, cfg.norm), group, gc)
    cx = tp.assemble(A.gqa_cross_apply(p["xattn"], cfg, q_in, enc_out,
                                       plan), group)
    resid = resid + cx
    x = x + cx
    mlp_in = (fal.block0_mlp_input(cfg, p, x, a) if is_block0
              else fal.mlp_input(cfg, p, x, a, a1_sig))
    y, aux = ffn(tp.enter(mlp_in, group, gc))
    y = tp.assemble(y, group)
    if cfg.post_norms:
        y = L.norm_apply(p["post_ffn"], y, cfg.norm)
    sig = fal.first_attention_signal(cfg, p, a) if is_block0 else None
    return resid + y, a, sig, aux


def _block_apply_sp(p, cfg, x_s, a1_sig, positions, window, *, kind,
                    is_block0, plan):
    """Sequence-parallel (Megatron-SP) block (reference ``:294-385``):
    ``x_s`` is this rank's (B, S/tp, D) shard of the residual stream and
    so is the output.  Returns (x_out_s, a_raw, a1_export, aux).  The FFN
    sees the gathered full sequence, so a MoE layer routes the same tokens
    on every rank and its partial sum joins the reduce-scatter.

      fused: all-gather(x_s) -> attention + MLP partials over the full
          sequence -> ONE reduce-scatter(a + y).
      assembled: all-gather(x_s) -> attention partial -> reduce-scatter(a)
          -> the MLP input on the shard -> all-gather -> MLP partial ->
          reduce-scatter(y).
      block 0 with a first-attention export (fal / falplus): the attention
          partial pays a true all-reduce instead of the reduce-scatter (the
          signal feeds every later block at every position), then the MLP
          input over the full sequence and one reduce-scatter(y).

    Norms are per token, so they apply to shards or gathered tensors
    alike.  Under ``plan.grad_compress`` the backward all-gather of each
    reduce-scatter and each *f*'s backward all-reduce are compressed."""
    group, gc = plan.tp_axis, plan.grad_compress
    x = tp.gather_seq(x_s, group)                      # (B, S, D)
    a = _attend(p, cfg, L.norm_apply(p["ln1"], x, cfg.norm), positions,
                window, plan)

    def ffn(h):
        return _ffn_apply(p, cfg, h, kind, plan)

    if _fused(cfg, is_block0):
        mlp_in = (fal.block0_mlp_input(cfg, p, x, a) if is_block0
                  else fal.mlp_input(cfg, p, x, a, a1_sig))
        y, aux = ffn(mlp_in)
        return x_s + tp.scatter_seq(a + y, group, gc), a, None, aux

    sig = None
    if is_block0 and cfg.connection in fal.USES_FIRST_ATTENTION:
        a = tp.assemble(a, group)
        if cfg.post_norms:
            a = L.norm_apply(p["post_attn"], a, cfg.norm)
        resid_s = x_s + tp.split_seq(a, group)
        sig = fal.first_attention_signal(cfg, p, a)
        if cfg.connection == "fal":
            sig_in = tp.enter(sig, group, gc)
            if _shared_signal(cfg):
                sig = sig_in
            mlp_in = fal.mlp_input(cfg, p, x, a, sig_in)
        else:
            mlp_in = fal.block0_mlp_input(cfg, p, x,
                                          tp.enter(a, group, gc))
    else:
        a_s = tp.scatter_seq(a, group, gc)             # complete, sharded
        if cfg.post_norms:
            a_s = L.norm_apply(p["post_attn"], a_s, cfg.norm)
        resid_s = x_s + a_s
        sig_s = tp.split_seq(a1_sig, group) if a1_sig is not None else None
        mlp_in_s = (fal.block0_mlp_input(cfg, p, x_s, a_s) if is_block0
                    else fal.mlp_input(cfg, p, x_s, a_s, sig_s))
        mlp_in = tp.gather_seq(mlp_in_s, group)        # LN region -> full
    y, aux = ffn(mlp_in)
    y_s = tp.scatter_seq(y, group, gc)
    if cfg.post_norms:
        y_s = L.norm_apply(p["post_ffn"], y_s, cfg.norm)
    return resid_s + y_s, a, sig, aux


#: MLA's leaves kept whole on every rank under explicit TP (reference
#: ``launch/mesh.py:58-61``); the up-projections and ``wo`` are sharded
MLA_REPLICATED = ("w_dq", "q_norm", "w_dkv", "kv_norm", "w_kr")


def tp_partial_leaves(cfg, plan, *, is_block0, kv_rep, moe=False,
                      cross=False):
    """Keys (paths into one block's params) of the replicated leaves whose
    gradient each rank holds as a partial sum under ``plan``'s placement of
    the collectives above: leaves used between an *f* (or a sequence
    all-gather) and the sharded weights see only this rank's share of the
    cotangent, and under SP a norm applied to a sequence shard sees only
    this rank's tokens.  The train step sums their gradients over the
    group (``models.model.tp_sync_grads``); every other replicated leaf's
    gradient is already whole and equal on every rank.  A MoE block's
    router (``moe``) is replicated and each rank's output covers only its
    experts, so its gradient is a partial sum too; so are MLA's replicated
    down-projections, their norms and the rope key's projection
    (``MLA_REPLICATED``), which feed only this rank's heads.  The MTP head
    runs outside the stack, whole on every rank, and is never listed.  A
    cross-attention block (``cross``, ``_block_apply_cross_tp``) enters
    every sharded branch behind its own *f*: only its qk-norms (and its
    replicated wk / wv) are partial, in both attentions."""
    keys = [("attn", "qnorm"), ("attn", "knorm")]
    if cross:
        keys += [("xattn", "qnorm"), ("xattn", "knorm")]
        if kv_rep:
            keys += [("attn", "wk"), ("attn", "wv"), ("xattn", "wk"),
                     ("xattn", "wv")]
        return keys
    if cfg.use_mla:
        keys += [("attn", k) for k in MLA_REPLICATED]
    if moe:
        keys.append(("ffn", "router"))
    if kv_rep:
        keys += [("attn", "wk"), ("attn", "wv")]
    if plan.sequence_parallel:
        export = is_block0 and cfg.connection in fal.USES_FIRST_ATTENTION
        keys += [("ln1",), ("ln2",), ("ln_fal",), ("post_ffn",)]
        if not export:
            keys.append(("post_attn",))
    elif _fused(cfg, is_block0) or (is_block0 and _shared_signal(cfg)):
        keys += [("ln1",), ("ln2",)]
    return keys


def window_schedule(cfg, n_layers=None):
    """Per-layer sliding windows as Python ints (0: full attention).  Under
    ``layer_pattern == "local_global"`` (gemma2) even layers are local
    (``cfg.sliding_window``) and odd layers global."""
    n = n_layers or cfg.n_layers
    if cfg.layer_pattern == "local_global" and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(n)]
    return [cfg.sliding_window] * n
