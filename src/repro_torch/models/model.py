"""The FAL decoder on torch tensors (dense and MoE FFNs, GQA or MLA
attention, DeepSeek-V3's MTP head, the VLM's image prefix): parameters, the
full-sequence forward and loss for training, the KV caches and the serving
ticks.

Port of the decoder of ``repro/models/model.py``: ``_layer_kind``
(``:66``: MoE from ``first_dense_layers`` on), ``cross_entropy``
(``:72``), ``_run_decoder_blocks`` (``:204``, the layer scan as a Python
loop, summing the MoE layers' aux), ``_decoder_forward`` (``:250``),
``forward`` (``:921``), ``_ce_tail`` (``:1103``), ``_mtp_loss``
(``:1086``) and ``loss_fn`` (``:1108``; ce + ``router_aux_coef`` x aux + 0.3
x mtp), with the reference's rematerialisation: under ``cfg.remat`` block
0, each later block, the CE tail and the MTP loss run under
``torch.utils.checkpoint`` (non-reentrant) while gradients are on.  And
the contiguous KV cache's ``init_cache`` (``:936``, ``_decoder_init_cache``
``:270``; MLA's latent caches) and ``decode_step`` (``:946`` ->
``_decoder_decode``, ``:337``), and the paged serving
paths: ``_embed_tokens``, ``_logits`` / ``lm_head``, ``init_paged_cache``
(``:957``), ``paged_decode_step`` (``:979``) -> ``_decoder_paged_packed``
(``:466``, the token-packed layout) or ``_decoder_paged_decode`` (``:388``,
the padded (B, C) layout, sequential or dual-branch), and
``_decoder_layer_stack`` (``:280``) and ``copy_paged_pages`` (``:1054``,
the device half of copy-on-write), plus ``init_params`` for the dense
decoder and the MoE family (``first_dense_layers`` dense blocks of width
``dense_d_ff``, then MoE blocks) with the ``mtp`` subtree (reference
``:106-116``) when ``cfg.mtp_depth``.  A VLM's image prefix enters where
the reference splices it (``_embed_tokens`` for the full sequence,
``_splice_image`` in the contiguous, padded and packed ticks): precomputed
patch embeddings in place of the first ``n_image_tokens`` positions' token
embeddings.  For self-speculative decoding: ``paged_spec_draft`` (``:1010``)
-> ``_decoder_paged_packed_draft`` (``:532``, the early-exit draft) and
``lm_head_segment_tail`` (``:1034``, the verify's head over each segment's
last rows).

Explicit tensor parallelism (``core/tp.py``): under an explicit-TP plan
(``ExecutionPlan.from_group``) ``forward`` and ``loss_fn`` run
``decoder_stack_tp`` (``:149-201``, the dispatch of ``:258-261``) on this
rank's shard of the blocks (``launch/mesh.py::shard_params``), remat
included, and ``tp_sync_grads`` sums the replicated leaves' partial
gradients after the backward.  The MTP head runs outside the stack on the
whole hidden states (reference ``:1097``), so its leaves' gradients are
whole on every rank and are not summed.  The serving ticks, contiguous
and paged, run the same blocks under such a plan (``serving_plan``):
each rank holds its shard and its KV heads' caches, in lockstep.  The
contiguous decode tick's cache takes the reference's layout
(``launch/mesh.py::cache_specs``): its KV sequence cut over the data
ranks where the batch does not divide them and over the model ranks where
the KV heads do not (MLA's latents always), each rank attending over its
positions and combining the partial softmaxes over those groups
(``attention.seq_combine``).

FSDP (``plan.fsdp``, ZeRO-3 over the data group; the reference's default
layout): the params hold this data rank's slices (``launch/mesh.py::
shard_fsdp``).  Each unit (block 0, every later block, the head, the MTP
head, every mamba layer, every invocation of zamba's shared block with its
``in_proj`` row, every whisper block) gathers its leaves first thing inside
its ``_maybe_remat`` (``_gather``): the recompute gathers again, only the
slices are saved, and the gather's backward reduce-scatters the unit's
gradients into the slices' ``.grad``.  The embedding, positions and norms
are never sliced, so what runs outside the units (the embedding, block 0's
``ln_a`` in ``fal.first_attention_signal``) reads the slices' tree as it
is.  The contiguous decode tick takes an FSDP plan too (``serving_plan``).

Parameters are a dict tree in the reference's layout, except that the
stacked ``blocks_dense`` and ``blocks_moe`` leaves (leading layer axis)
become one list of per-layer dicts under ``"blocks"``, in depth order (the
dense ones first); a block's kind is ``blocks.is_moe``.  Every path passes each layer its
sliding window (``blocks.window_schedule``: gemma2's local / global
alternation) as a Python int.  The cache holds block 0's pools, one
``(n_layers - 1, P, page, Hkv, Dh)`` tensor per K and per V for the other
layers (and, on quantized pages, one ``(n_layers - 1, P, page)`` fp32 tensor
per row-scale pool; under MLA the latent pools ``c`` and ``kr`` instead of
K and V), and the per-slot ``a1_sig``; a tick updates all of them in
place.

The other three families (reference ``:583-908``), each with its own
parameters, forward, cache and decode step behind the reference's family
dispatch (``init_params``, ``forward``, ``init_cache``, ``decode_step``;
``loss_fn`` through ``forward``): the SSM family (mamba2, ``_mamba_*``:
``ln`` then ``ssm.mamba_apply`` a layer, ``"blocks"`` a list), the hybrid
(zamba2, ``_zamba_*``: groups of ``attn_every`` mamba layers, each group
followed by one invocation of the weight-shared attention block through
its group's ``in_proj`` over ``[x, x_emb0]``, then the trailing mamba
layers; ``"mamba"`` a list of groups, each a list of layers) and the audio
encoder-decoder (whisper, ``whisper_encode`` and ``_whisper_*``: a
bidirectional encoder over the stubbed frame embeddings, decoder blocks
with cross-attention; ``"enc_blocks"`` / ``"dec_blocks"`` lists).  Their
caches are contiguous only: the paged entry points refuse them with the
reference's error (``PAGED_FAMILIES``).  The recurrent leaves of a cache
(mamba's ``state`` and ``conv``) are written in place like the KV rows.
Under an explicit-TP plan each runs as the reference's ``param_specs``
lay it out: mamba2's layers whole on every rank (no collective),
zamba2's shared block and whisper's encoder and decoder blocks on this
rank's shard through ``blocks.block_apply_tp`` (``_apply_block0`` for a
stack's block 0, whose export is the signal).

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when there is none.  Pass ``device="cpu"`` to run the plain versions of
the kernels on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core import fal
from repro_torch.core import tp
from repro_torch.core.plan import (ExecutionPlan, Phase, kv_replicated,
                                   local_kv_heads)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as MX
from repro_torch.models import attention as A
from repro_torch.models import blocks as BL
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``, which must exist; an explicit device as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the card; "
                "pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


#: families the port runs: the decoder with dense or MoE FFNs (GQA or MLA
#: attention, an optional MTP head), the VLM's decoder with its image
#: prefix, mamba2 (ssm), zamba2 (hybrid) and whisper (audio)
SUPPORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")

#: families with a paged KV cache (reference ``:954``); the others serve
#: from the contiguous cache only
PAGED_FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg):
    """Raise NotImplementedError for a family the port does not know."""
    if cfg.family not in SUPPORTED_FAMILIES:
        raise NotImplementedError(
            f"family '{cfg.family}': the PyTorch port runs "
            f"{', '.join(SUPPORTED_FAMILIES)}")


def _refuse_unpaged(cfg, what):
    """The reference's refusal of a paged entry point for a family without
    a paged cache (``:972-974``, ``:993-995``, ``:1021-1023``)."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(f"{what}: decoder family only, got "
                                  f"{cfg.family}")


def _layer_kind(cfg, i):
    """Layer ``i``'s FFN: MoE from ``first_dense_layers`` on when the
    config has experts, else dense."""
    if cfg.n_experts and i >= cfg.first_dense_layers:
        return "moe"
    return "dense"


def layer_kinds(cfg, n_layers=None):
    """Every layer's kind, block 0 first."""
    return [_layer_kind(cfg, i) for i in range(n_layers or cfg.n_layers)]


def _dtype(name) -> torch.dtype:
    return getattr(torch, name)


# ------------------------------------------------------------------------- #
# parameters
# ------------------------------------------------------------------------- #
def init_params(cfg, seed=0, device=None, dtype=None):
    """Random weights of the config's family at the reference's scales,
    drawn with a ``torch.Generator`` on ``device`` (on the CPU for a
    ``meta`` device, whose tensors hold no numbers; not the reference's
    numbers: tests carry JAX weights across with
    ``interop.params_from_numpy``).  Matmul weights and embeddings are
    stored in ``dtype``: None keeps ``cfg.dtype`` (serving); training
    passes ``cfg.param_dtype`` (fp32 masters, cast to ``cfg.dtype`` at each
    use).  Norms, and the mamba mixer's ``a_log`` / ``dt_bias`` / ``D``,
    stay fp32."""
    check_supported(cfg)
    device = resolve_device(device)
    # a meta init draws no numbers: a CPU generator drives it
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    dt = _dtype(dtype or cfg.dtype)
    init = {"ssm": _mamba_init, "hybrid": _zamba_init,
            "audio": _whisper_init}.get(cfg.family, _decoder_init)
    return init(gen, cfg, dt, device)


def _decoder_init(gen, cfg, dt, device):
    p = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt, device)}
    if cfg.learned_pos:
        p["pos_emb"] = (torch.randn((cfg.max_seq, cfg.d_model), generator=gen,
                                    device=device) * 0.02).to(dt)
    kinds = layer_kinds(cfg)
    p["block0"] = BL.block_init(gen, cfg, dt, device, kind=kinds[0],
                                is_block0=True)
    p["blocks"] = [BL.block_init(gen, cfg, dt, device, kind=kind)
                   for kind in kinds[1:]]
    p["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, device)
    if not cfg.tie_embeddings:
        p["head"] = {"w": L.dense_init(gen, cfg.d_model, cfg.vocab, dt,
                                       device)}
    if cfg.mtp_depth:
        # DeepSeek-V3's MTP head (reference ``:106-116``): a plain preln
        # block outside the main depth, so FAL's rewiring does not apply
        p["mtp"] = {
            "proj": {"w": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                       dt, device)},
            "norm_h": L.norm_init(cfg.d_model, cfg.norm, device),
            "norm_e": L.norm_init(cfg.d_model, cfg.norm, device),
            "block": BL.block_init(gen, _mtp_cfg(cfg), dt, device,
                                   kind="dense"),
        }
    return p


def _mtp_cfg(cfg):
    """The MTP head block's config: the model's, connection preln."""
    return cfg.replace(connection="preln")


# ------------------------------------------------------------------------- #
# embeddings and head
# ------------------------------------------------------------------------- #
def _embed_tokens(p, cfg, tokens, positions, image_embeds=None):
    """Token embeddings (scaled, plus learned positions where the config
    has them).  A VLM's full-sequence batch replaces the first
    ``n_image_tokens`` positions by its precomputed patch embeddings
    ``image_embeds`` (B, n_image_tokens, D) (reference ``:130-139``)."""
    x = L.embed_apply(p["embed"], tokens, _dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.learned_pos:
        x = x + p["pos_emb"].to(x.dtype)[positions.long()]
    if image_embeds is not None and cfg.n_image_tokens:
        n = cfg.n_image_tokens
        x = torch.cat([image_embeds.to(x.dtype), x[:, n:]], dim=1)
    return x


def _splice_image(cfg, batch, x, positions):
    """The serving ticks' image prefix (reference ``:341-345``, ``:417-421``,
    ``:493-497``): rows at positions < ``n_image_tokens`` take the batch's
    ``image_embeds`` (the patch embedding of each row's position, in x's
    layout) in place of their token embedding."""
    if not (cfg.n_image_tokens and "image_embeds" in batch):
        return x
    img = batch["image_embeds"].to(x.dtype)
    if img.dim() < x.dim():
        img = img[None]                                   # packed: (T, D)
    return torch.where((positions < cfg.n_image_tokens)[..., None], img, x)


def _gather(tree, cfg, plan, prefix, cuts=None):
    """One unit's params (a block, the head, the MTP head, a mamba layer)
    with their FSDP slices gathered over the data group under
    ``plan.fsdp`` (``tp.gather_fsdp``: one all-gather, its backward one
    reduce-scatter), called first thing inside the unit's
    ``_maybe_remat``; ``tree`` as given otherwise.  ``prefix``: the
    unit's path in the params, whose entries of ``launch.mesh.
    fsdp_layout`` are the unit's ``cuts`` unless these are given."""
    if plan is None or not plan.fsdp:
        return tree
    if cuts is None:
        cuts = MX.fsdp_cuts(cfg, plan.tp_size, plan.dp_size, prefix)
    return tp.gather_fsdp(tree, cuts, plan.data_group)


def _logits(p, cfg, x, plan=None):
    x = L.norm_apply(p["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        return L.unembed_apply(p["embed"], x, cfg.final_softcap)
    head = _gather(p["head"], cfg, plan, ("head",))
    return L.softcap(L.dense_apply(head["w"], x), cfg.final_softcap)


def lm_head(params, cfg, x):
    """Final norm + (tied) unembedding: hidden (B, S, D) -> (B, S, V)."""
    return _logits(params, cfg, x)


# ------------------------------------------------------------------------- #
# full-sequence forward and loss (training)
# ------------------------------------------------------------------------- #
def cross_entropy(logits, labels, mask=None):
    """Mean next-token NLL: logits to fp32, then ``logsumexp`` minus the
    label's logit (masked mean when ``mask`` is given)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()


def _maybe_remat(fn, cfg):
    """``fn`` under non-reentrant activation checkpointing when
    ``cfg.remat`` and gradients are on (the reference's ``jax.checkpoint``):
    its activations are recomputed in the backward, kernels included."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _aux_total(aux, device):
    return aux if aux is not None else torch.zeros(
        (), dtype=torch.float32, device=device)


def _run_decoder_blocks(p, cfg, x, positions, plan):
    """Block 0, then the later blocks as a Python loop (the reference scans
    over stacked params), each under ``_maybe_remat`` and with its window
    from ``window_schedule`` and its kind from ``layer_kinds``.  The
    first-attention signal is formed from block 0's output outside its
    checkpoint, as in the reference.  Returns (x, aux): the sum of the MoE
    layers' load-balance terms (0 for a dense model)."""
    wsched = BL.window_schedule(cfg)
    kinds = layer_kinds(cfg)

    def block0(pb, h):
        pb = _gather(pb, cfg, plan, ("block0",))
        return BL.block_apply(pb, cfg, h, None, kind=kinds[0],
                              is_block0=True, plan=plan, positions=positions,
                              window=wsched[0])

    def block(pb, h, a1_sig, window, kind, i):
        pb = _gather(pb, cfg, plan, ("blocks", i))
        out, _, aux = BL.block_apply(pb, cfg, h, a1_sig, kind=kind,
                                     plan=plan, positions=positions,
                                     window=window)
        return out, aux

    x, a1_raw, aux = _maybe_remat(block0, cfg)(p["block0"], x)
    # ln_a is never FSDP-sliced: the slices' tree serves here
    a1_sig = fal.first_attention_signal(cfg, p["block0"], a1_raw)
    for i, (pb, w, kind) in enumerate(zip(p["blocks"], wsched[1:],
                                          kinds[1:])):
        x, aux_i = _maybe_remat(functools.partial(block, kind=kind, i=i),
                                cfg)(pb, x, a1_sig, w)
        aux = BL.add_aux(aux, aux_i)
    return x, _aux_total(aux, x.device)


def _first_tp_block(p):
    """A block of the params whose attention explicit TP shards: the
    decoder's ``block0``, whisper's ``enc_block0``, zamba2's ``shared``;
    None for mamba2, whose layers stay whole on every rank."""
    for key in ("block0", "enc_block0", "shared"):
        if key in p:
            return p[key]
    return None


def _check_shards(p, cfg, tp_size):
    """The explicit-TP stack runs on this rank's shard of the blocks
    (``launch.mesh.shard_params``); full weights would compute tp times
    the attention and FFN and sum them."""
    block = _first_tp_block(p)
    if block is None:
        return
    if cfg.use_mla:
        name = "w_uq"
        width = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    else:
        name, width = "wq", cfg.resolved_head_dim
    got = block["attn"][name].shape[-1]
    if got * tp_size != cfg.n_heads * width:
        raise ValueError(
            f"explicit TP over {tp_size} ranks: {name} has {got} columns, "
            f"expected {cfg.n_heads * width // tp_size}; pass this rank's "
            f"shard (launch.mesh.shard_params)")


def decoder_stack_tp(p, cfg, x, positions, plan):
    """Block 0 and the later blocks under explicit tensor parallelism
    (reference ``model.py:149-201``): ``p`` holds this rank's shard of the
    blocks, x (B, S, D) is replicated on every rank and so is the output.
    The blocks see ``plan.inner()`` and pay the collectives of
    ``blocks.block_apply_tp``: fal / parallel one all-reduce per
    steady-state block, preln / falplus two, and block 0 the one extra
    that exports the first-attention signal.  With
    ``plan.sequence_parallel`` the residual stream between blocks is this
    rank's (B, S/tp, D) slice (``tp.split_seq`` in, ``tp.unsplit_seq``
    out): every per-block all-reduce becomes a reduce-scatter at 1/tp the
    bytes behind an all-gather.  Remat as on one device.  Returns (x,
    aux): MoE layers run this rank's experts (``moe.moe_apply_partial``)
    and aux, the same on every TP rank, is summed over the blocks; under a
    data group its value is the group's mean (the reference's pmean over
    the data axes) while its gradient stays this rank's (the train step
    averages the gradients over the data group)."""
    plan.validate(cfg)
    tp_size = plan.tp_size
    _check_shards(p, cfg, tp_size)
    sp = plan.sequence_parallel
    if sp and x.shape[1] % tp_size:
        raise ValueError(
            f"sequence_parallel: seq len {x.shape[1]} is not divisible by "
            f"tp_size={tp_size} (the residual stream shards evenly or not "
            f"at all)")
    inner = plan.inner()
    wsched = BL.window_schedule(cfg)
    kinds = layer_kinds(cfg)

    def block0(pb, h):
        pb = _gather(pb, cfg, plan, ("block0",))
        h, _, sig, aux = BL.block_apply_tp(
            pb, cfg, h, None, kind=kinds[0], is_block0=True, plan=inner,
            positions=positions, window=wsched[0])
        return h, sig, aux

    def block(pb, h, a1_sig, window, kind, i):
        pb = _gather(pb, cfg, plan, ("blocks", i))
        out, _, _, aux = BL.block_apply_tp(
            pb, cfg, h, a1_sig, kind=kind, plan=inner, positions=positions,
            window=window)
        return out, aux

    if sp:
        x = tp.split_seq(x, plan.group)
    x, a1_sig, aux = _maybe_remat(block0, cfg)(p["block0"], x)
    for i, (pb, w, kind) in enumerate(zip(p["blocks"], wsched[1:],
                                          kinds[1:])):
        x, aux_i = _maybe_remat(functools.partial(block, kind=kind, i=i),
                                cfg)(pb, x, a1_sig, w)
        aux = BL.add_aux(aux, aux_i)
    if sp:
        x = tp.unsplit_seq(x, plan.group)
    aux = _aux_total(aux, x.device)
    if cfg.n_experts and plan.data_group is not None:
        mean = tp.all_reduce(aux, plan.data_group, "metric") / plan.dp_size
        aux = aux + (mean - aux).detach()
    return x, aux


def _tp_blocks(params, cfg):
    """(block, is_block0, cross) of every transformer block the explicit-TP
    paths run: the decoder's ``block0`` and ``blocks``; whisper's encoder
    stack and its decoder stack (cross-attention); zamba2's shared block
    once (``plan.validate`` holds every invocation to the same partial
    leaves, so its one gradient, summed over the invocations, is partial
    throughout or whole throughout); none for mamba2."""
    if cfg.family == "ssm":
        return []
    if cfg.family == "hybrid":
        return [(params["shared"], True, False)]
    if cfg.family == "audio":
        return ([(params["enc_block0"], True, False)]
                + [(b, False, False) for b in params["enc_blocks"]]
                + [(params["dec_block0"], True, True)]
                + [(b, False, True) for b in params["dec_blocks"]])
    return [(params["block0"], True, False)] + [
        (b, False, False) for b in params["blocks"]]


def tp_sync_grads(params, cfg, plan):
    """Sum over the TP group, in ONE all-reduce, the gradients that each
    rank holds as a partial sum of a replicated leaf
    (``blocks.tp_partial_leaves``); afterwards every replicated leaf's
    gradient is whole and equal on every rank.  Call after the backward
    (and after the last microbatch).  Under FSDP a listed leaf that is
    also sliced (a MoE router, MLA's down-projections) holds its slice's
    gradient, already reduce-scattered over the data group: the TP sum
    acts on the slice (both sums are linear, so either order gives the
    one device's gradient).  Every family's blocks (``_tp_blocks``):
    zamba2's shared block's listed leaves hold the sum of all its
    invocations' partial gradients, summed over the group once; mamba2
    lists none (no collective)."""
    kv_rep = kv_replicated(cfg, plan.tp_size)
    grads = []
    for pb, is0, cross in _tp_blocks(params, cfg):
        for key in BL.tp_partial_leaves(cfg, plan, is_block0=is0,
                                        kv_rep=kv_rep, moe=BL.is_moe(pb),
                                        cross=cross):
            node = pb
            for k in key:
                node = node.get(k) if isinstance(node, dict) else None
            if node is None:
                continue
            leaves = node.values() if isinstance(node, dict) else [node]
            grads += [t.grad for t in leaves]
    tp.all_reduce_(grads, plan.group)


def _decoder_forward(p, cfg, batch, plan, want="logits"):
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed_tokens(p, cfg, tokens, positions, batch.get("image_embeds"))
    if plan.use_explicit_tp:
        x, aux = decoder_stack_tp(p, cfg, x, positions, plan)
    else:
        x, aux = _run_decoder_blocks(p, cfg, x, positions, plan)
    if want == "hidden":
        return None, aux, {"hidden": x}
    return _logits(p, cfg, x, plan), aux, {}


def forward(params, cfg, batch, plan=None, want="logits"):
    """Full-sequence forward: batch {"tokens" (B, S)} (whisper's also
    "frames" (B, F, D)) -> (logits (B, S, V), aux, extras), or with
    ``want='hidden'`` (None, aux, {"hidden": (B, S, D)}).  ``plan``: an
    ExecutionPlan, a Phase or its string value, or None (train)."""
    check_supported(cfg)
    plan = ExecutionPlan.resolve(plan).validate(cfg)
    if not plan.full_sequence:
        raise ValueError(f"forward: phase={plan.phase.value} is not a "
                         f"full-sequence phase; use decode_step / "
                         f"paged_decode_step")
    fn = {"ssm": _mamba_forward, "hybrid": _zamba_forward,
          "audio": _whisper_forward}.get(cfg.family)
    if fn is None:
        return _decoder_forward(params, cfg, batch, plan, want=want)
    if plan.use_explicit_tp:
        _check_shards(params, cfg, plan.tp_size)
    return fn(params, cfg, batch, plan, want=want)


def _ce_tail(p, cfg, hidden, tokens, plan=None):
    logits = _logits(p, cfg, hidden, plan)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


def _mtp_loss(p, cfg, batch, hidden, plan=None):
    """DeepSeek-V3's multi-token prediction (reference ``:1086-1100``):
    predict token t + 2 from the final hidden state h_t and the embedding
    of token t + 1, through ``proj`` and the preln MTP block (full
    sequence, one device: under explicit TP it runs outside the stack on
    the whole hidden states, its weights whole on every rank), then the
    model's head."""
    tokens = batch["tokens"]
    mtp = _gather(p["mtp"], cfg, plan, ("mtp",))
    emb_next = L.embed_apply(p["embed"], tokens[:, 1:], _dtype(cfg.dtype))
    z = torch.cat([L.norm_apply(mtp["norm_h"], hidden[:, :-1], cfg.norm),
                   L.norm_apply(mtp["norm_e"], emb_next, cfg.norm)], -1)
    z = L.dense_apply(mtp["proj"]["w"], z)
    B, S1 = z.shape[:2]
    positions = torch.arange(S1, device=z.device)[None].expand(B, S1)
    z, _, _ = BL.block_apply(mtp["block"], _mtp_cfg(cfg), z, None,
                             kind="dense", positions=positions)
    logits = _logits(p, cfg, z, plan)                         # (B, S-1, V)
    return cross_entropy(logits[:, :-1], tokens[:, 2:])


def loss_fn(params, cfg, batch, plan=None):
    """-> (loss, metrics): next-token cross entropy of the forward's hidden
    states through the head, under ``_maybe_remat`` so the (B, S, V)
    logits are recomputed in the backward instead of kept, plus
    ``router_aux_coef`` x the MoE aux; metrics {"ce", "aux"}.  With an MTP
    head (``cfg.mtp_depth`` and ``params["mtp"]``) the loss adds 0.3 x its
    cross entropy, under ``_maybe_remat`` too, and metrics carry "mtp"."""
    plan = ExecutionPlan.resolve(plan)
    _, aux, extras = forward(params, cfg, batch, plan, want="hidden")
    tail = _maybe_remat(functools.partial(_ce_tail, cfg=cfg, plan=plan),
                        cfg)
    ce = tail(params, hidden=extras["hidden"], tokens=batch["tokens"])
    loss = ce + cfg.router_aux_coef * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth and "mtp" in params:
        mtp_fn = _maybe_remat(functools.partial(_mtp_loss, cfg=cfg,
                                                plan=plan), cfg)
        mtp = mtp_fn(params, batch=batch, hidden=extras["hidden"])
        loss = loss + 0.3 * mtp
        metrics["mtp"] = mtp
    return loss, metrics


# ------------------------------------------------------------------------- #
# contiguous KV cache and its one-token step
# ------------------------------------------------------------------------- #
def _stacked(cfg, c0):
    """Block 0's cache leaves ``c0`` and, for the other layers, one
    (n_layers - 1, ...) copy of each."""
    return {"block0": c0, "blocks": _stacked_n(c0, cfg.n_layers - 1)}


def _cache_dims(cfg, key, dims, tp_size, dp_size):
    """A rank's lengths of a cache leaf's leading dims ``dims`` (the global
    batch first) under the reference's layout (``launch/mesh.py::
    cache_specs``); every rank's slice has these lengths."""
    spec = MX.cache_specs(cfg, tp_size, dp_size, dims[0])[key]
    return tuple(hi - lo for lo, hi in (
        MX.part_range(n, axes, 0, 0, tp_size, dp_size)
        for n, axes in zip(dims, spec)))


def _decoder_init_cache(cfg, batch, seq, dtype, device, tp_size=1,
                        dp_size=1):
    if cfg.use_mla:
        b, s = _cache_dims(cfg, "c", (batch, seq), tp_size, dp_size)
        return _stacked(cfg, A.mla_init_cache(cfg, b, s, dtype, device))
    b, s, h = _cache_dims(cfg, "k", (batch, seq, cfg.n_kv_heads), tp_size,
                          dp_size)
    return _stacked(cfg, A.gqa_init_cache(cfg, b, s, dtype, device,
                                          n_kv_heads=h))


def init_cache(cfg, batch, seq, dtype="bfloat16", device=None, tp_size=1,
               dp_size=1):
    """Contiguous KV cache for ``decode_step``: block 0's (B, S, Hkv, Dh)
    K and V, and one (n_layers - 1, B, S, Hkv, Dh) tensor per K and per V
    for the other layers (the paged cache's stacking), zeros in
    ``dtype``; under MLA the latent ``c`` (B, S, rkv) and rope key ``kr``
    (B, S, dr) stacked likewise.  The other families' caches are the
    reference's: ``_mamba_init_cache``, ``_zamba_init_cache``,
    ``_whisper_init_cache``.

    ``tp_size`` / ``dp_size``: a rank's slice of the cache of the global
    ``batch`` and ``seq`` over that many model and data ranks, by the
    reference's layout (``launch/mesh.py::cache_specs``): its rows (the
    batch over the data ranks when it divides them), its KV heads (over
    the model ranks when they divide them) and its positions (the
    sequence over the data ranks when the batch does not divide them, and
    over the model ranks when the KV heads do not, or always for MLA's
    latents); mamba's state / conv and whisper's ``enc_out`` by batch
    only, whole over the model ranks and where the batch does not divide
    the data ranks.  Every rank's slice has one shape (no cut is padded:
    a dim that does not divide raises), so the zeros do not depend on the
    rank; the decode plan carries which positions are whose
    (``ExecutionPlan.with_cache_layout``)."""
    check_supported(cfg)
    device = resolve_device(device)
    fn = {"ssm": _mamba_init_cache, "hybrid": _zamba_init_cache,
          "audio": _whisper_init_cache}.get(cfg.family, _decoder_init_cache)
    return fn(cfg, batch, seq, _dtype(dtype), device, tp_size, dp_size)


def _decoder_decode(p, cfg, batch, cache, plan):
    """tokens (B, 1), pos (B,) each lane's position -> (logits (B, 1, V),
    cache updated in place).  Block 0's fresh first-attention signal feeds
    every later block of the tick, dual-branch too."""
    tokens, pos = batch["tokens"], batch["pos"]
    x = _embed_tokens(p, cfg, tokens, pos[:, None])
    x = _splice_image(cfg, batch, x, pos[:, None])
    x, _, a1_sig = _serve_block0(p, cfg, x, plan, cache=cache["block0"],
                                 pos=pos)
    x = _decoder_layer_stack(p, cfg, x, a1_sig, pos, cache["blocks"], plan,
                             block_tables=None)
    return _logits(p, cfg, x, plan), cache


def decode_step(params, cfg, batch, cache, plan=None):
    """One token a lane against the contiguous cache (``init_cache``):
    batch {"tokens" (B, 1), "pos" (B,)} -> (logits (B, 1, V), cache updated
    in place).  ``plan`` may carry ``dual_branch`` (fal / parallel /
    ablation2 only), and an explicit-TP group (every family): ``params``
    is then this rank's shard and ``cache`` this rank's (``init_cache(...,
    tp_size=)``); see ``serving_plan``."""
    check_supported(cfg)
    plan = serving_plan(params, cfg, plan, Phase.DECODE)
    fn = {"ssm": _mamba_decode, "hybrid": _zamba_decode,
          "audio": _whisper_decode}.get(cfg.family, _decoder_decode)
    return fn(params, cfg, batch, cache, plan)


# ------------------------------------------------------------------------- #
# paged cache and the paged ticks
# ------------------------------------------------------------------------- #
def init_paged_cache(cfg, num_pages, page_size, slots, dtype="bfloat16",
                     kv_dtype="", device=None, tp_size=1):
    """Paged KV cache: block 0's (P, page, Hkv, Dh) pools, one
    (n_layers - 1, P, page, Hkv, Dh) tensor per K and per V for the other
    layers, and the per-slot FAL signal (slots, d_model) in ``dtype``.  Page
    0 is scratch.  ``kv_dtype`` selects the page format
    (``attention.gqa_init_paged_cache``); int8 / fp8 pools come with
    (P, page) fp32 ``k_scale`` / ``v_scale`` pools, stacked likewise.
    Under MLA the pools are the latent ``c`` (P, page, rkv) and rope key
    ``kr`` (P, page, dr), and a ``kv_dtype`` raises, as in the
    reference.  ``tp_size``: the ranks of an explicit-TP plan; each rank's
    pools hold its ``local_kv_heads`` (``Hkv / tp``, or the one KV head its
    query heads attend when ``n_kv_heads < tp``), its scale pools one
    scale a row as on one device; MLA's latent pools are whole on every
    rank (the reference shards their sequence over ``model``,
    ``launch/mesh.py:184-186``: the same function, tp times the bytes) and
    so is ``a1_sig``.  The families without a paged cache raise the
    reference's NotImplementedError."""
    check_supported(cfg)
    _refuse_unpaged(cfg, "paged KV cache")
    device = resolve_device(device)
    dt = _dtype(dtype)
    if cfg.use_mla:
        if kv_dtype:
            raise NotImplementedError(
                "quantized KV pages (kv_dtype) are GQA-only: the MLA cache "
                "stores latents, not per-head K/V rows")
        c0 = A.mla_init_paged_cache(cfg, num_pages, page_size, dt, device)
    else:
        c0 = A.gqa_init_paged_cache(cfg, num_pages, page_size, dt, device,
                                    kv_dtype=kv_dtype,
                                    n_kv_heads=local_kv_heads(cfg, tp_size))
    return {**_stacked(cfg, c0),
            "a1_sig": torch.zeros((slots, cfg.d_model), dtype=dt,
                                  device=device)}


def _apply_block0(pb, cfg, x, plan, **kw):
    """A stack's block 0 (``pb``, gathered) -> (x, a_raw, a1_sig): its
    output, its MHA output and the first-attention signal the later blocks
    take (None for the modes without one).  Under an explicit-TP plan it
    is ``blocks.block_apply_tp`` over this rank's shard, whose export is
    the signal, exactly as in ``decoder_stack_tp``; ``a_raw`` is then this
    rank's partial sum where block 0 does not assemble its attention
    (``parallel``, which never reads it).  ``kw``: ``block_apply``'s
    keywords (kind, window, cache arguments, positions, causal,
    enc_out)."""
    if plan.use_explicit_tp:
        x, a_raw, sig, _ = BL.block_apply_tp(pb, cfg, x, None, is_block0=True,
                                             plan=plan.inner(), **kw)
        return x, a_raw, sig
    x, a_raw, _ = BL.block_apply(pb, cfg, x, None, is_block0=True, plan=plan,
                                 **kw)
    return x, a_raw, fal.first_attention_signal(cfg, pb, a_raw)


def _serve_block0(p, cfg, x, plan, **kw):
    """Block 0 of a serving tick -> (x, a_raw, a1_sig) (``_apply_block0``
    on this rank's gathered block 0).  ``kw``: the tick's cache
    arguments."""
    pb = _gather(p["block0"], cfg, plan, ("block0",))
    return _apply_block0(pb, cfg, x, plan, kind=_layer_kind(cfg, 0),
                         window=BL.window_schedule(cfg)[0], **kw)


def _decoder_layer_stack(p, cfg, x, a1_sig, pos, blocks_cache, plan, *,
                         block_tables, n_valid=None, tok_slot=None,
                         tok_pos=None, limit=None):
    """The post-block-0 layers as a Python loop (the reference scans).
    Layer i reads and writes the i-th slice of the stacked caches in place
    (the paged pools or the contiguous (B, S, Hkv, Dh) caches), where the
    reference concatenates per-layer caches.  ``limit`` runs only
    the first ``limit`` layers (the speculative draft's early exit); the
    pools of the layers past it are not touched.  Each layer attends with
    its window from ``window_schedule`` (``wsched[1:]``) and its FFN kind
    from ``layer_kinds``; the MoE layers' aux is not used when serving.
    Under an explicit-TP plan every block sees ``plan.inner()``, so it runs
    ``blocks.block_apply_tp`` (or, under ``dual_branch``, the MHA || MLP
    block that merges both partials before its one all-reduce) on this
    rank's shard and this rank's pools."""
    wsched = BL.window_schedule(cfg)[1:]
    kinds = layer_kinds(cfg)[1:]
    if plan.use_explicit_tp:
        plan = plan.inner()
    for i, pb in enumerate(p["blocks"][:limit]):
        layer_cache = {k: v[i] for k, v in blocks_cache.items()}
        pb = _gather(pb, cfg, plan, ("blocks", i))
        x, _, _ = BL.block_apply(pb, cfg, x, a1_sig, kind=kinds[i],
                                 plan=plan, cache=layer_cache,
                                 block_tables=block_tables, pos=pos,
                                 n_valid=n_valid, tok_slot=tok_slot,
                                 tok_pos=tok_pos, window=wsched[i])
    return x


def _decoder_paged_decode(p, cfg, batch, cache, plan, want="logits"):
    """Padded chunked tick: tokens (B, C), pos (B,) per-lane first logical
    position, n_valid (B,) valid tokens per lane (the rest go to the
    scratch page), block_tables (B, T).  Returns (logits (B, C, V) or
    hidden (B, C, D), cache updated in place).  C == 1 runs the decode
    kernel, C > 1 the chunk kernel.

    Under ``plan.dual_branch`` the blocks after block 0 run the MHA || MLP
    dispatch, reading the per-slot first-attention signal refreshed by block
    0 at the top of the tick; on a C == 1 tick each active lane reads this
    tick's fresh export and each idle lane its cached one."""
    tokens, pos = batch["tokens"], batch["pos"]
    bt, n_valid = batch["block_tables"], batch["n_valid"]
    C = tokens.shape[1]
    positions = pos[:, None] + torch.arange(C, device=pos.device)[None]
    x = _splice_image(cfg, batch, _embed_tokens(p, cfg, tokens, positions),
                      positions)
    x, a1_raw, a1_sig = _serve_block0(p, cfg, x, plan, cache=cache["block0"],
                                      block_tables=bt, pos=pos,
                                      n_valid=n_valid)

    # stash each lane's export at its last valid position before the
    # steady-state stack runs; lanes sitting this tick out (n_valid == 0)
    # keep their cached signal
    sig = a1_sig if a1_sig is not None else a1_raw               # (B, C, D)
    last = (n_valid - 1).clamp(0, C - 1).long()
    lanes = torch.arange(sig.shape[0], device=sig.device)
    new_sig = sig[lanes, last].to(cache["a1_sig"].dtype)
    active = (n_valid > 0)[:, None]
    cache["a1_sig"] = torch.where(active, new_sig, cache["a1_sig"])

    if plan.dual_branch and a1_sig is not None and C == 1:
        # active lanes keep this tick's fresh activation-dtype export (the
        # cache dtype would round it); idle lanes read their cached signal
        a1_sig = torch.where(active, sig[:, 0],
                             cache["a1_sig"].to(x.dtype))[:, None, :]

    x = _decoder_layer_stack(p, cfg, x, a1_sig, pos, cache["blocks"], plan,
                             block_tables=bt, n_valid=n_valid)
    if want == "hidden":
        return x, cache
    return _logits(p, cfg, x, plan), cache


def _decoder_paged_packed(p, cfg, batch, cache, plan, want="logits"):
    """Token-packed ragged tick: tokens (T,), tok_slot (T,), tok_pos (T,)
    (-1 = padding), block_tables (S, Tb), seg_last (S,) index of each
    slot's last packed token (-1 = slot sat the tick out).  Returns
    (logits (1, T, V) or hidden (1, T, D), cache updated in place)."""
    tokens, bt = batch["tokens"], batch["block_tables"]
    tok_slot, tok_pos = batch["tok_slot"], batch["tok_pos"]
    seg_last = batch["seg_last"]
    positions = tok_pos.clamp(min=0)[None]                      # (1, T)
    x = _splice_image(cfg, batch,
                      _embed_tokens(p, cfg, tokens[None], positions),
                      positions)
    x, a1_raw, a1_sig = _serve_block0(p, cfg, x, plan, cache=cache["block0"],
                                      block_tables=bt, tok_slot=tok_slot,
                                      tok_pos=tok_pos)

    # refresh the per-slot FAL export from each active segment's LAST
    # packed token; slots sitting this tick out keep their cached signal
    sig = a1_sig if a1_sig is not None else a1_raw               # (1, T, D)
    active = seg_last >= 0
    new_sig = sig[0, seg_last.clamp(min=0).long()].to(cache["a1_sig"].dtype)
    cache["a1_sig"] = torch.where(active[:, None], new_sig, cache["a1_sig"])

    x = _decoder_layer_stack(p, cfg, x, a1_sig, None, cache["blocks"], plan,
                             block_tables=bt, tok_slot=tok_slot,
                             tok_pos=tok_pos)
    if want == "hidden":
        return x, cache
    return _logits(p, cfg, x, plan), cache


def _decoder_paged_packed_draft(p, cfg, batch, cache, plan, draft_blocks):
    """Early-exit packed forward of the speculative draft: block 0 and the
    first ``draft_blocks - 1`` later layers over the packed batch ->
    (hidden (1, T, D), cache).  K/V is written for those layers only (the
    verify pass rewrites those rows with the same values and is the first
    writer of every deeper layer).  ``cache["a1_sig"]`` is not refreshed:
    the per-slot signal tracks the lane's last accepted position, which
    only the verify pass knows.  Its dispatches record ``<site>.draft``."""
    tokens, bt = batch["tokens"], batch["block_tables"]
    tok_slot, tok_pos = batch["tok_slot"], batch["tok_pos"]
    positions = tok_pos.clamp(min=0)[None]                      # (1, T)
    with ops.dispatch_site_suffix("draft"):
        x = _embed_tokens(p, cfg, tokens[None], positions)
        x, _, a1_sig = _serve_block0(p, cfg, x, plan, cache=cache["block0"],
                                     block_tables=bt, tok_slot=tok_slot,
                                     tok_pos=tok_pos)
        x = _decoder_layer_stack(p, cfg, x, a1_sig, None, cache["blocks"],
                                 plan, block_tables=bt, tok_slot=tok_slot,
                                 tok_pos=tok_pos, limit=draft_blocks - 1)
    return x, cache


def serving_plan(params, cfg, plan, phase):
    """The plan of a serving tick, pinned to ``phase`` and validated.  A
    plan over a process group serves only under ``tp='explicit'``, every
    family (``EXPLICIT_TP_FAMILIES``); ``params`` must then be this
    rank's shard (``_check_shards``).  A decode plan carries its
    cache layout (``seq_axes``; when unset, that of a batch that divides
    the data ranks).  A data group raises (a data replica is an engine of
    its own) except in the contiguous decode tick, where either the
    layout cuts the KV sequence over it (``ExecutionPlan.
    with_cache_layout`` of a batch the data ranks do not divide, such as
    long_500k's one row): every data rank then serves the same rows in
    lockstep, like TP ranks, and combines its partial softmax over the
    group; or the plan is FSDP's, where every data rank serves its own
    rows in lockstep.  Either way an FSDP plan gathers each block's slices
    over the group as the forward does; without FSDP the weights are
    whole on each data rank.  The paged ticks take no sequence-cut
    layout.

    Under explicit TP every rank runs the same tick on the same replicated
    batch in lockstep: the embedding, the head, ``a1_sig`` and the image
    prefix are replicated, the blocks run ``blocks.block_apply_tp`` on
    this rank's heads and FFN columns (or experts) and their pools, and
    each block's sum all-reduce makes the residual stream the same bytes
    on every rank (the forward's L + 1 all-reduces under fal, 2L under
    preln / falplus).  On int8 / fp8 pages each layer adds one MAX
    all-reduce of its rows' K / V amax (``attention._scatter_kv``), so
    every rank quantizes with the one-device scale."""
    plan = ExecutionPlan.resolve(plan).with_phase(phase)
    decode = plan.phase is Phase.DECODE
    if decode and plan.seq_axes is None:
        plan = plan.with_cache_layout(cfg)
    elif not decode and plan.seq_axes:
        raise ValueError(
            f"a sequence-cut cache layout (seq_axes={plan.seq_axes}) in a "
            f"{plan.phase.value} tick: only the contiguous decode tick's "
            f"cache is cut by sequence; the paged pools are not")
    if plan.data_group is not None and not (
            decode and (plan.fsdp or "data" in plan.seq_axes)):
        raise ValueError(
            "a data-parallel group in a serving tick: a data replica is a "
            "separate engine (one per rank), and a tick never reduces over "
            "replicas (only the contiguous decode tick takes one: with its "
            "KV sequence cut over the group, ExecutionPlan."
            "with_cache_layout, or under FSDP)")
    if plan.is_sharded:
        if not plan.use_explicit_tp:
            raise NotImplementedError(
                f"a serving tick over a process group needs tp='explicit' "
                f"(got tp='{plan.tp.value}'): the port's serving ticks "
                f"shard only through the explicit partial-sum blocks")
    plan.validate(cfg)
    if plan.use_explicit_tp:
        _check_shards(params, cfg, plan.tp_size)
    return plan


def paged_decode_step(params, cfg, batch, cache, plan=None, want="logits"):
    """One paged tick -> (logits or, with ``want='hidden'``, the pre-head
    hidden states; cache updated in place) in either paged layout:

      * token-packed (the serving engine's tick; the batch carries
        ``tok_slot``): see ``_decoder_paged_packed``; (1, T, V) / (1, T, D);
      * padded chunk (tokens (B, C) with per-lane ``pos`` / ``n_valid``):
        see ``_decoder_paged_decode``; (B, C, V) / (B, C, D).

    ``plan`` may carry ``dual_branch`` (fal / parallel / ablation2 only)
    and an explicit-TP group (``serving_plan``: ``params`` and ``cache``
    are then this rank's, ``init_paged_cache(..., tp_size=)``)."""
    check_supported(cfg)
    _refuse_unpaged(cfg, "paged decode")
    plan = serving_plan(params, cfg, plan, Phase.PAGED)
    if "tok_slot" in batch:
        return _decoder_paged_packed(params, cfg, batch, cache, plan,
                                     want=want)
    return _decoder_paged_decode(params, cfg, batch, cache, plan, want=want)


def paged_spec_draft(params, cfg, batch, cache, plan=None, *, draft_blocks=1):
    """Self-speculative draft forward on the token-packed layout
    (``model.py:1010``): embed, block 0 and the first ``draft_blocks - 1``
    later layers -> (hidden (1, T, D), cache updated in place), the stack
    the engine's draft loop runs ``lm_head`` over.  The batch is
    ``_decoder_paged_packed``'s without ``seg_last``.  Requires
    1 <= draft_blocks < cfg.n_layers."""
    check_supported(cfg)
    _refuse_unpaged(cfg, "speculative draft")
    if not 1 <= draft_blocks < cfg.n_layers:
        raise ValueError(
            f"draft_blocks={draft_blocks} must satisfy 1 <= draft_blocks "
            f"< n_layers={cfg.n_layers} (== n_layers would be the full "
            f"model, not a draft)")
    plan = serving_plan(params, cfg, plan, Phase.PAGED)
    return _decoder_paged_packed_draft(params, cfg, batch, cache, plan,
                                       draft_blocks)


def lm_head_segment_tail(params, cfg, hidden, seg_last, n):
    """The head over each segment's last ``n`` packed rows, for the
    speculative verify (``model.py:1034``): rows ``seg_last[s] - (n - 1) ..
    seg_last[s]`` of ``hidden`` (1, T, D) -> (logits (S, n, V), rows (S, n)
    int32).  Rows of lanes sitting the tick out (``seg_last == -1``) and
    rows that would fall before row 0 are read at row 0 and zeroed before
    the head; the caller masks which columns are live."""
    off = torch.arange(n, dtype=torch.int32, device=seg_last.device) - (n - 1)
    rows = seg_last[:, None] + off[None, :]                      # (S, n)
    valid = (seg_last >= 0)[:, None] & (rows >= 0)
    h = hidden[0, rows.clamp(min=0).long()]                      # (S, n, D)
    h = torch.where(valid[:, :, None], h, torch.zeros_like(h))
    return _logits(params, cfg, h), rows


def copy_paged_pages(cache, src, dst):
    """Copy-on-write page copy across every layer's pools, in place: the
    rows of physical pages ``src`` (n,) are written over pages ``dst`` (n,)
    in block 0's pools and in all stacked pools of the other layers, scale
    pools included (the device half of ``BlockTable`` copy-on-write; the
    host half swaps the block-table entry).

    ``src`` / ``dst`` are host sequences of page ids (K / V pools, or
    MLA's latent ``c`` and ``kr`` pools).  One
    ``ops.copy_page_leaves`` call for every pool leaf: block 0's pools as
    they are, the stacked (L-1, P, ...) pools in every layer (one kernel
    launch for the whole cache on the card; the reference makes one
    ``ops.copy_pages`` call a leaf, with the ids offset per layer).
    ``a1_sig`` is per slot, not per page: untouched.  Returns the cache."""
    ops.copy_page_leaves(
        [(pool, False) for pool in cache["block0"].values()]
        + [(pool, True) for pool in cache["blocks"].values()], src, dst)
    return cache


# ------------------------------------------------------------------------- #
# MambaLM (ssm): a stack of Mamba2 layers
# ------------------------------------------------------------------------- #
def _mamba_block_init(gen, cfg, dt, device):
    return {"ln": L.norm_init(cfg.d_model, cfg.norm, device),
            "mixer": S.mamba_init(gen, cfg, dt, device)}


def _mamba_init(gen, cfg, dt, device):
    """Reference ``:589-596``; the stacked ``blocks`` are a list here."""
    return {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt, device),
        "blocks": [_mamba_block_init(gen, cfg, dt, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device),
    }


def _mamba_layer(pb, h, cfg, plan=None, prefix=()):
    pb = _gather(pb, cfg, plan, prefix)
    y, _ = S.mamba_apply(pb["mixer"], cfg, L.norm_apply(pb["ln"], h,
                                                        cfg.norm))
    return h + y


def _mamba_seg(blocks, cfg, x, plan=None, prefix=()):
    """Mamba layers over the full sequence, each under ``_maybe_remat``;
    layer i's params sit at ``prefix + (i,)`` (its FSDP unit)."""
    for i, pb in enumerate(blocks):
        layer = functools.partial(_mamba_layer, cfg=cfg, plan=plan,
                                  prefix=prefix + (i,))
        x = _maybe_remat(layer, cfg)(pb, x)
    return x


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _mamba_forward(p, cfg, batch, plan, want="logits"):
    """Reference ``:599-617``."""
    x = L.embed_apply(p["embed"], batch["tokens"], _dtype(cfg.dtype))
    x = _mamba_seg(p["blocks"], cfg, x, plan, ("blocks",))
    if want == "hidden":
        return None, _zero_aux(x), {"hidden": x}
    return _logits(p, cfg, x, plan), _zero_aux(x), {}


def _layers_of(cache, n):
    """A stacked cache subtree -> one dict of views a layer."""
    return [{k: v[i] for k, v in cache.items()} for i in range(n)]


def _stacked_n(c, n):
    """Leaves of one layer's cache ``c`` stacked n times (zeros)."""
    return {k: v[None].repeat((n,) + (1,) * v.dim()) for k, v in c.items()}


def _mamba_init_cache(cfg, batch, seq, dtype, device, tp_size=1,
                      dp_size=1):
    """{"blocks": {"state" (L, B, H, P, N) fp32, "conv" (L, B, K-1,
    conv_dim)}} (reference ``:620-623``); a data rank's rows of them,
    whole over the model ranks."""
    b, = _cache_dims(cfg, "state", (batch,), 1, dp_size)
    return {"blocks": _stacked_n(S.mamba_init_cache(cfg, b, dtype, device),
                                 cfg.n_layers)}


def _mamba_decode_seg(blocks, cfg, x, cache, plan=None, prefix=()):
    """One token through mamba layers, each layer's {"state", "conv"}
    (views of the stacked cache) written in place."""
    for i, (pb, c) in enumerate(zip(blocks, _layers_of(cache, len(blocks)))):
        pb = _gather(pb, cfg, plan, prefix + (i,))
        y, new = S.mamba_decode(pb["mixer"], cfg,
                                L.norm_apply(pb["ln"], x, cfg.norm), c)
        x = x + y
        for k, v in new.items():
            c[k].copy_(v)
    return x


def _mamba_decode(p, cfg, batch, cache, plan):
    """Reference ``:626-639``: tokens (B, 1) -> (logits (B, 1, V), cache
    updated in place).  ``pos`` is not read: the state is the history."""
    x = L.embed_apply(p["embed"], batch["tokens"], _dtype(cfg.dtype))
    x = _mamba_decode_seg(p["blocks"], cfg, x, cache["blocks"], plan,
                          ("blocks",))
    return _logits(p, cfg, x, plan), cache


# ------------------------------------------------------------------------- #
# ZambaLM (hybrid): a mamba2 backbone and one weight-shared attention block
# ------------------------------------------------------------------------- #
def _zamba_counts(cfg):
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.attn_every


def _zamba_init(gen, cfg, dt, device):
    """Reference ``:648-671``: ``mamba`` a list of ``n_groups`` groups of
    ``attn_every`` layers, ``mamba_tail`` the trailing layers, ONE shared
    block (built as block 0: ``ln_a``, no ``ln_fal``; ``shared_ln_fal``
    joins it at each invocation where the mode has one) and the groups'
    input projections ``in_proj`` (n_groups, 2 d, d)."""
    n_groups, trailing = _zamba_counts(cfg)
    d = cfg.d_model
    p = {
        "embed": L.embed_init(gen, cfg.vocab, d, dt, device),
        "mamba": [[_mamba_block_init(gen, cfg, dt, device)
                   for _ in range(cfg.attn_every)] for _ in range(n_groups)],
        "shared": BL.block_init(gen, cfg, dt, device, kind="dense",
                                is_block0=True),
        "in_proj": (torch.randn((n_groups, 2 * d, d), generator=gen,
                                device=device) / np.sqrt(2 * d)).to(dt),
        "final_norm": L.norm_init(d, cfg.norm, device),
    }
    if cfg.connection in fal.NEEDS_LN_FAL:
        p["shared_ln_fal"] = L.norm_init(d, cfg.norm, device)
    if trailing:
        p["mamba_tail"] = [_mamba_block_init(gen, cfg, dt, device)
                           for _ in range(trailing)]
    return p


def _zamba_shared_cuts(cfg, plan):
    """The FSDP cuts of one invocation's unit {"shared", "in_proj"}: the
    shared block's, and its group's row of ``in_proj`` (the (n_groups, 2d,
    d) leaf's dim less the group axis)."""
    cuts = {("shared",) + k: c for k, c in MX.fsdp_cuts(
        cfg, plan.tp_size, plan.dp_size, ("shared",)).items()}
    whole = MX.fsdp_cuts(cfg, plan.tp_size, plan.dp_size, ("in_proj",))
    if () in whole:
        dim, n = whole[()]
        cuts[("in_proj",)] = (dim - 1, n)
    return cuts


def _zamba_shared_block(p, cfg, x, x0, in_proj, a1_sig, positions, *,
                        first, plan, cache=None, pos=None):
    """One invocation of the weight-shared attention block (reference
    ``:674-686``): its input is ``[x, x0] @ in_proj``, and only its delta
    ``out - h_in`` joins the backbone's residual stream.  Returns (x, the
    first-attention signal: invocation 0's export, None after it).  Under
    FSDP each invocation gathers the shared block and its ``in_proj``
    row; the shared leaves' gradient is the sum of the invocations'
    reduce-scatters.  Under explicit TP ``in_proj`` is whole on every rank
    and the block runs on this rank's shard: invocation 0 as a TP block 0
    (``_apply_block0``: under fal its attention and FFN all-reduces and
    the signal's one *f*), the later ones on ``plan.inner()`` (under fal
    the fused path, one all-reduce each; under a dual-branch decode plan
    the MHA || MLP block, one too)."""
    if plan.fsdp:
        unit = _gather({"shared": p["shared"], "in_proj": in_proj}, cfg,
                       plan, None, _zamba_shared_cuts(cfg, plan))
        p, in_proj = dict(p, shared=unit["shared"]), unit["in_proj"]
    h_in = torch.cat([x, x0], dim=-1) @ in_proj.to(x.dtype)
    shared = dict(p["shared"])
    if "shared_ln_fal" in p:
        shared["ln_fal"] = p["shared_ln_fal"]
    kw = dict(kind="dense", cache=cache, pos=pos, positions=positions)
    if first:
        out, _, sig = _apply_block0(shared, cfg, h_in, plan, **kw)
    else:
        inner = plan.inner() if plan.use_explicit_tp else plan
        out, _, _ = BL.block_apply(shared, cfg, h_in, a1_sig, plan=inner,
                                   **kw)
        sig = None
    return x + (out - h_in), sig


def _zamba_forward(p, cfg, batch, plan, want="logits"):
    """Reference ``:689-732``: group 0 (under one ``_maybe_remat``, its
    layers each under their own) exports the first-attention signal, then
    the later groups (each under ``_maybe_remat``), then the tail.  Under
    explicit TP the mamba layers run whole on every rank (no collective)
    and the shared block on this rank's shard (``_zamba_shared_block``)."""
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
    x0 = L.embed_apply(p["embed"], tokens, _dtype(cfg.dtype))

    def group(pm, in_proj, h, a1_sig, first, g):
        h = _mamba_seg(pm, cfg, h, plan, ("mamba", g))
        return _zamba_shared_block(p, cfg, h, x0, in_proj, a1_sig, positions,
                                   first=first, plan=plan)

    x, a1_sig = _maybe_remat(group, cfg)(p["mamba"][0], p["in_proj"][0],
                                         x0, None, True, 0)
    for g in range(1, len(p["mamba"])):
        x, _ = _maybe_remat(group, cfg)(p["mamba"][g], p["in_proj"][g], x,
                                        a1_sig, False, g)
    x = _mamba_seg(p.get("mamba_tail", []), cfg, x, plan, ("mamba_tail",))
    if want == "hidden":
        return None, _zero_aux(x), {"hidden": x}
    return _logits(p, cfg, x, plan), _zero_aux(x), {}


def _zamba_init_cache(cfg, batch, seq, dtype, device, tp_size=1,
                      dp_size=1):
    """Reference ``:735-745``: ``mamba`` {"state", "conv"} stacked
    (n_groups, attn_every, ...), ``attn`` the shared block's K / V a group
    (n_groups, B, S, Hkv, Dh), ``mamba_tail`` stacked (trailing, ...); a
    rank's slice of them (the K / V heads over the model ranks, the
    recurrent leaves whole over them)."""
    n_groups, trailing = _zamba_counts(cfg)
    b, = _cache_dims(cfg, "state", (batch,), tp_size, dp_size)
    mc = S.mamba_init_cache(cfg, b, dtype, device)
    b, s, h = _cache_dims(cfg, "k", (batch, seq, cfg.n_kv_heads), tp_size,
                          dp_size)
    cache = {"mamba": _stacked_n(_stacked_n(mc, cfg.attn_every), n_groups),
             "attn": _stacked_n(A.gqa_init_cache(cfg, b, s, dtype, device,
                                                 n_kv_heads=h), n_groups)}
    if trailing:
        cache["mamba_tail"] = _stacked_n(mc, trailing)
    return cache


def _zamba_decode(p, cfg, batch, cache, plan):
    """Reference ``:748-801``: the shared block's invocations read rope
    from ``pos`` (``positions=None``); under ``plan.dual_branch`` those
    after the first run the MHA || MLP block."""
    tokens, pos = batch["tokens"], batch["pos"]
    x0 = L.embed_apply(p["embed"], tokens, _dtype(cfg.dtype))
    x, a1_sig = x0, None
    attn = _layers_of(cache["attn"], len(p["mamba"]))
    for g, pm in enumerate(p["mamba"]):
        mc = {k: v[g] for k, v in cache["mamba"].items()}
        x = _mamba_decode_seg(pm, cfg, x, mc, plan, ("mamba", g))
        x, sig = _zamba_shared_block(p, cfg, x, x0, p["in_proj"][g], a1_sig,
                                     None, first=g == 0, plan=plan,
                                     cache=attn[g], pos=pos)
        if g == 0:
            a1_sig = sig
    if "mamba_tail" in p:
        x = _mamba_decode_seg(p["mamba_tail"], cfg, x, cache["mamba_tail"],
                              plan, ("mamba_tail",))
    return _logits(p, cfg, x, plan), cache


# ------------------------------------------------------------------------- #
# Whisper (audio encoder-decoder): the mel / conv front end is a stub; the
# inputs are precomputed frame embeddings, as in the reference
# ------------------------------------------------------------------------- #
def _whisper_init(gen, cfg, dt, device):
    """Reference ``:804-822``; the stacked encoder and decoder blocks are
    lists here.  The decoder blocks carry cross-attention."""
    d = cfg.d_model

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.02).to(dt)

    return {
        "embed": L.embed_init(gen, cfg.vocab, d, dt, device),
        "pos_emb": normal((cfg.max_seq, d)),
        "enc_pos": normal((cfg.n_enc_frames, d)),
        "enc_block0": BL.block_init(gen, cfg, dt, device, is_block0=True),
        "enc_blocks": [BL.block_init(gen, cfg, dt, device)
                       for _ in range(cfg.n_enc_layers - 1)],
        "enc_norm": L.norm_init(d, cfg.norm, device),
        "dec_block0": BL.block_init(gen, cfg, dt, device, cross=True,
                                    is_block0=True),
        "dec_blocks": [BL.block_init(gen, cfg, dt, device, cross=True)
                       for _ in range(cfg.n_layers - 1)],
        "final_norm": L.norm_init(d, cfg.norm, device),
    }


def _stack_apply(p, cfg, blocks, x, plan, prefixes, **kw):
    """Block 0 (``blocks[0]``, exporting the first-attention signal) and
    the later blocks, each under ``_maybe_remat`` -> x; ``prefixes``: each
    block's path in the params (its FSDP unit).  ``kw``: the blocks'
    shared keywords (positions, causal, enc_out).  Under explicit TP the
    blocks run on this rank's shard (``blocks.block_apply_tp``): the
    encoder's on the decoders' paths, the decoder's cross-attention
    blocks assembled."""
    inner = plan.inner() if plan.use_explicit_tp else plan

    def block0(pb, h):
        pb = _gather(pb, cfg, plan, prefixes[0])
        h, _, sig = _apply_block0(pb, cfg, h, plan, **kw)
        return h, sig

    def block(pb, h, sig, prefix):
        pb = _gather(pb, cfg, plan, prefix)
        return BL.block_apply(pb, cfg, h, sig, plan=inner, **kw)[0]

    x, a1_sig = _maybe_remat(block0, cfg)(blocks[0], x)
    for pb, prefix in zip(blocks[1:], prefixes[1:]):
        x = _maybe_remat(functools.partial(block, prefix=prefix), cfg)(
            pb, x, a1_sig)
    return x


def _stack_prefixes(p, first, rest):
    """The paths of a whisper stack's blocks: ``(first,)``, then ``(rest,
    i)`` for each of ``p[rest]``."""
    return [(first,)] + [(rest, i) for i in range(len(p[rest]))]


def whisper_encode(p, cfg, frames, plan=None):
    """The encoder (reference ``:825-844``): frames (B, F, d) stubbed frame
    embeddings plus ``enc_pos``, bidirectional blocks (no rope, no mask)
    with their own block-0 signal, then ``enc_norm`` -> (B, F, d), whole
    on every rank under explicit TP (the blocks' all-reduces assemble
    it)."""
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.PREFILL)
    dt = _dtype(cfg.dtype)
    x = frames.to(dt) + p["enc_pos"].to(dt)[None, :frames.shape[1]]
    x = _stack_apply(p, cfg, [p["enc_block0"]] + p["enc_blocks"], x, plan,
                     _stack_prefixes(p, "enc_block0", "enc_blocks"),
                     causal=False)
    return L.norm_apply(p["enc_norm"], x, cfg.norm)


def _whisper_forward(p, cfg, batch, plan, want="logits"):
    """Reference ``:847-870``: the encoder over ``batch["frames"]``, then
    the decoder over the tokens plus the learned ``pos_emb``, each block
    cross-attending to the encoder's output.  Under explicit TP the
    encoder's output enters the decoder's column-split cross K / V through
    one *f* (``tp.enter``), whose backward all-reduce sums the decoder
    blocks' partial gradients into the encoder's whole one."""
    enc_out = whisper_encode(p, cfg, batch["frames"], plan)
    if plan.use_explicit_tp:
        enc_out = tp.enter(enc_out, plan.group, plan.grad_compress)
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
    dt = _dtype(cfg.dtype)
    x = L.embed_apply(p["embed"], tokens, dt) \
        + p["pos_emb"].to(dt)[None, :Sq]
    x = _stack_apply(p, cfg, [p["dec_block0"]] + p["dec_blocks"], x, plan,
                     _stack_prefixes(p, "dec_block0", "dec_blocks"),
                     positions=positions, enc_out=enc_out)
    if want == "hidden":
        return None, _zero_aux(x), {"hidden": x}
    return _logits(p, cfg, x, plan), _zero_aux(x), {}


def _whisper_init_cache(cfg, batch, seq, dtype, device, tp_size=1,
                        dp_size=1):
    """Reference ``:873-882``: the decoder's K / V (block 0, the stacked
    rest) and ``enc_out`` (B, n_enc_frames, d), which the caller fills with
    ``whisper_encode``'s output; a rank's slice of them (the K / V heads
    over the model ranks, ``enc_out`` whole over them)."""
    b, s, h = _cache_dims(cfg, "k", (batch, seq, cfg.n_kv_heads), tp_size,
                          dp_size)
    cache = _stacked(cfg, A.gqa_init_cache(cfg, b, s, dtype, device,
                                           n_kv_heads=h))
    b, = _cache_dims(cfg, "enc_out", (batch,), tp_size, dp_size)
    cache["enc_out"] = torch.zeros((b, cfg.n_enc_frames, cfg.d_model),
                                   dtype=dtype, device=device)
    return cache


def _whisper_decode(p, cfg, batch, cache, plan):
    """Reference ``:885-908``: the token plus ``pos_emb[pos]``, each block
    cross-attending to ``cache["enc_out"]`` (cast to ``cfg.dtype``; its K /
    V are recomputed every step, as the reference keeps no cross cache).
    Under explicit TP each block runs on this rank's shard and its K / V
    heads (three all-reduces a block)."""
    tokens, pos = batch["tokens"], batch["pos"]
    dt = _dtype(cfg.dtype)
    enc_out = cache["enc_out"].to(dt)
    x = L.embed_apply(p["embed"], tokens, dt) \
        + p["pos_emb"].to(dt)[pos.long()][:, None]
    pb0 = _gather(p["dec_block0"], cfg, plan, ("dec_block0",))
    x, _, a1_sig = _apply_block0(pb0, cfg, x, plan, enc_out=enc_out,
                                 cache=cache["block0"], pos=pos)
    inner = plan.inner() if plan.use_explicit_tp else plan
    for i, (pb, c) in enumerate(zip(p["dec_blocks"], _layers_of(
            cache["blocks"], len(p["dec_blocks"])))):
        pb = _gather(pb, cfg, plan, ("dec_blocks", i))
        x, _, _ = BL.block_apply(pb, cfg, x, a1_sig, plan=inner,
                                 enc_out=enc_out, cache=c, pos=pos)
    return _logits(p, cfg, x, plan), cache
