"""The FAL decoder on torch tensors (dense and MoE FFNs): parameters, the
full-sequence forward and loss for training, the paged KV cache and the
paged ticks.

Port of the decoder of ``repro/models/model.py``: ``_layer_kind``
(``:66``: MoE from ``first_dense_layers`` on), ``cross_entropy``
(``:72``), ``_run_decoder_blocks`` (``:204``, the layer scan as a Python
loop, summing the MoE layers' aux), ``_decoder_forward`` (``:250``),
``forward`` (``:921``), ``_ce_tail`` (``:1103``) and ``loss_fn`` (``:1108``;
ce + ``router_aux_coef`` x aux; no MTP head), with the reference's rematerialisation: under
``cfg.remat`` block 0, each later block and the CE tail run under
``torch.utils.checkpoint`` (non-reentrant) while gradients are on.  And
the contiguous KV cache's ``init_cache`` (``:936``, ``_decoder_init_cache``
``:270``) and ``decode_step`` (``:946`` -> ``_decoder_decode``, ``:337``; the
VLM image-prefix splice waits for the VLM slice), and the paged serving
paths: ``_embed_tokens``, ``_logits`` / ``lm_head``, ``init_paged_cache``
(``:957``), ``paged_decode_step`` (``:979``) -> ``_decoder_paged_packed``
(``:466``, the token-packed layout) or ``_decoder_paged_decode`` (``:388``,
the padded (B, C) layout, sequential or dual-branch), and
``_decoder_layer_stack`` (``:280``) and ``copy_paged_pages`` (``:1054``,
the device half of copy-on-write), plus ``init_params`` for the dense
decoder and the MoE family (``first_dense_layers`` dense blocks of width
``dense_d_ff``, then MoE blocks).  For self-speculative decoding: ``paged_spec_draft`` (``:1010``)
-> ``_decoder_paged_packed_draft`` (``:532``, the early-exit draft) and
``lm_head_segment_tail`` (``:1034``, the verify's head over each segment's
last rows).

Explicit tensor parallelism (``core/tp.py``): under an explicit-TP plan
(``ExecutionPlan.from_group``) ``forward`` and ``loss_fn`` run
``decoder_stack_tp`` (``:149-201``, the dispatch of ``:258-261``) on this
rank's shard of the blocks (``launch/mesh.py::shard_params``), remat
included, and ``tp_sync_grads`` sums the replicated leaves' partial
gradients after the backward.  The serving ticks, contiguous and paged,
refuse a sharded plan.

Parameters are a dict tree in the reference's layout, except that the
stacked ``blocks_dense`` and ``blocks_moe`` leaves (leading layer axis)
become one list of per-layer dicts under ``"blocks"``, in depth order (the
dense ones first); a block's kind is ``blocks.is_moe``.  Every path passes each layer its
sliding window (``blocks.window_schedule``: gemma2's local / global
alternation) as a Python int.  The cache holds block 0's pools, one
``(n_layers - 1, P, page, Hkv, Dh)`` tensor per K and per V for the other
layers (and, on quantized pages, one ``(n_layers - 1, P, page)`` fp32 tensor
per row-scale pool), and the per-slot ``a1_sig``; a tick updates all of them
in place.

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
from repro_torch.core.plan import ExecutionPlan, Phase, kv_replicated
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import blocks as BL
from repro_torch.models import layers as L


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``, which must exist; an explicit device as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the card; "
                "pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


#: families the port runs: the decoder with dense or MoE FFNs
SUPPORTED_FAMILIES = ("dense", "moe")


def check_supported(cfg):
    """Raise NotImplementedError for what the port does not cover yet
    (VLM, SSM, hybrid and audio families, MLA attention), naming the slice
    that will."""
    if cfg.family not in SUPPORTED_FAMILIES:
        raise NotImplementedError(
            f"family '{cfg.family}': the PyTorch port serves the dense and "
            f"MoE decoders; VLM, SSM, hybrid and audio come in the "
            f"family-breadth slices (ROADMAP.md Queue 1)")
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA attention (deepseek-v3) comes in a later family-breadth "
            "slice of the PyTorch port (ROADMAP.md Queue 1)")


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
    """Random decoder weights at the reference's scales, drawn with a
    ``torch.Generator`` on ``device`` (not the reference's numbers: tests
    carry JAX weights across with ``interop.params_from_numpy``).  Matmul
    weights and embeddings are stored in ``dtype``: None keeps
    ``cfg.dtype`` (serving); training passes ``cfg.param_dtype`` (fp32
    masters, cast to ``cfg.dtype`` at each use).  Norms stay fp32."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = _dtype(dtype or cfg.dtype)
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
    return p


# ------------------------------------------------------------------------- #
# embeddings and head
# ------------------------------------------------------------------------- #
def _embed_tokens(p, cfg, tokens, positions):
    x = L.embed_apply(p["embed"], tokens, _dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.learned_pos:
        x = x + p["pos_emb"].to(x.dtype)[positions.long()]
    return x


def _logits(p, cfg, x):
    x = L.norm_apply(p["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        return L.unembed_apply(p["embed"], x, cfg.final_softcap)
    return L.softcap(L.dense_apply(p["head"]["w"], x), cfg.final_softcap)


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
        return BL.block_apply(pb, cfg, h, None, kind=kinds[0],
                              is_block0=True, plan=plan, positions=positions,
                              window=wsched[0])

    def block(pb, h, a1_sig, window, kind):
        out, _, aux = BL.block_apply(pb, cfg, h, a1_sig, kind=kind,
                                     plan=plan, positions=positions,
                                     window=window)
        return out, aux

    x, a1_raw, aux = _maybe_remat(block0, cfg)(p["block0"], x)
    a1_sig = fal.first_attention_signal(cfg, p["block0"], a1_raw)
    for pb, w, kind in zip(p["blocks"], wsched[1:], kinds[1:]):
        x, aux_i = _maybe_remat(functools.partial(block, kind=kind), cfg)(
            pb, x, a1_sig, w)
        aux = BL.add_aux(aux, aux_i)
    return x, _aux_total(aux, x.device)


def _check_shards(p, cfg, tp_size):
    """The explicit-TP stack runs on this rank's shard of the blocks
    (``launch.mesh.shard_params``); full weights would compute tp times
    the attention and FFN and sum them."""
    Dh = cfg.resolved_head_dim
    got = p["block0"]["attn"]["wq"].shape[-1]
    if got * tp_size != cfg.n_heads * Dh:
        raise ValueError(
            f"explicit TP over {tp_size} ranks: wq has {got} columns, "
            f"expected {cfg.n_heads * Dh // tp_size}; pass this rank's "
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
        h, _, sig, aux = BL.block_apply_tp(
            pb, cfg, h, None, kind=kinds[0], is_block0=True, plan=inner,
            positions=positions, window=wsched[0])
        return h, sig, aux

    def block(pb, h, a1_sig, window, kind):
        out, _, _, aux = BL.block_apply_tp(
            pb, cfg, h, a1_sig, kind=kind, plan=inner, positions=positions,
            window=window)
        return out, aux

    if sp:
        x = tp.split_seq(x, plan.group)
    x, a1_sig, aux = _maybe_remat(block0, cfg)(p["block0"], x)
    for pb, w, kind in zip(p["blocks"], wsched[1:], kinds[1:]):
        x, aux_i = _maybe_remat(functools.partial(block, kind=kind), cfg)(
            pb, x, a1_sig, w)
        aux = BL.add_aux(aux, aux_i)
    if sp:
        x = tp.unsplit_seq(x, plan.group)
    aux = _aux_total(aux, x.device)
    if cfg.n_experts and plan.data_group is not None:
        mean = tp.all_reduce(aux, plan.data_group, "metric") / plan.dp_size
        aux = aux + (mean - aux).detach()
    return x, aux


def tp_sync_grads(params, cfg, plan):
    """Sum over the TP group, in ONE all-reduce, the gradients that each
    rank holds as a partial sum of a replicated leaf
    (``blocks.tp_partial_leaves``); afterwards every replicated leaf's
    gradient is whole and equal on every rank.  Call after the backward
    (and after the last microbatch)."""
    kv_rep = kv_replicated(cfg, plan.tp_size)
    grads = []
    for pb, is0 in [(params["block0"], True)] + [
            (b, False) for b in params["blocks"]]:
        for key in BL.tp_partial_leaves(cfg, plan, is_block0=is0,
                                        kv_rep=kv_rep, moe=BL.is_moe(pb)):
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
    x = _embed_tokens(p, cfg, tokens, positions)
    if plan.use_explicit_tp:
        x, aux = decoder_stack_tp(p, cfg, x, positions, plan)
    else:
        x, aux = _run_decoder_blocks(p, cfg, x, positions, plan)
    if want == "hidden":
        return None, aux, {"hidden": x}
    return _logits(p, cfg, x), aux, {}


def forward(params, cfg, batch, plan=None, want="logits"):
    """Full-sequence forward of the decoder: batch {"tokens" (B, S)}
    -> (logits (B, S, V), aux, extras), or with ``want='hidden'`` (None,
    aux, {"hidden": (B, S, D)}).  ``plan``: an ExecutionPlan, a Phase or
    its string value, or None (train)."""
    check_supported(cfg)
    plan = ExecutionPlan.resolve(plan).validate(cfg)
    if not plan.full_sequence:
        raise ValueError(f"forward: phase={plan.phase.value} is not a "
                         f"full-sequence phase; use decode_step / "
                         f"paged_decode_step")
    return _decoder_forward(params, cfg, batch, plan, want=want)


def _ce_tail(p, cfg, hidden, tokens):
    logits = _logits(p, cfg, hidden)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


def loss_fn(params, cfg, batch, plan=None):
    """-> (loss, {"ce", "aux"}): next-token cross entropy of the forward's
    hidden states through the head, under ``_maybe_remat`` so the (B, S, V)
    logits are recomputed in the backward instead of kept."""
    plan = ExecutionPlan.resolve(plan)
    _, aux, extras = forward(params, cfg, batch, plan, want="hidden")
    tail = _maybe_remat(functools.partial(_ce_tail, cfg=cfg), cfg)
    ce = tail(params, hidden=extras["hidden"], tokens=batch["tokens"])
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------------- #
# contiguous KV cache and its one-token step
# ------------------------------------------------------------------------- #
def _stacked(cfg, c0):
    """Block 0's cache leaves ``c0`` and, for the other layers, one
    (n_layers - 1, ...) copy of each."""
    rest = cfg.n_layers - 1
    return {"block0": c0,
            "blocks": {k: v[None].repeat((rest,) + (1,) * v.dim())
                       for k, v in c0.items()}}


def _decoder_init_cache(cfg, batch, seq, dtype, device):
    return _stacked(cfg, A.gqa_init_cache(cfg, batch, seq, dtype, device))


def init_cache(cfg, batch, seq, dtype="bfloat16", device=None):
    """Contiguous KV cache for ``decode_step``: block 0's (B, S, Hkv, Dh)
    K and V, and one (n_layers - 1, B, S, Hkv, Dh) tensor per K and per V
    for the other layers (the paged cache's stacking), zeros in
    ``dtype``."""
    check_supported(cfg)
    return _decoder_init_cache(cfg, batch, seq, _dtype(dtype),
                               resolve_device(device))


def _decoder_decode(p, cfg, batch, cache, plan):
    """tokens (B, 1), pos (B,) each lane's position -> (logits (B, 1, V),
    cache updated in place).  Block 0's fresh first-attention signal feeds
    every later block of the tick, dual-branch too."""
    tokens, pos = batch["tokens"], batch["pos"]
    x = _embed_tokens(p, cfg, tokens, pos[:, None])
    x, a1_raw, _ = BL.block_apply(p["block0"], cfg, x, None,
                                  kind=_layer_kind(cfg, 0), is_block0=True,
                                  plan=plan, cache=cache["block0"], pos=pos,
                                  window=BL.window_schedule(cfg)[0])
    a1_sig = fal.first_attention_signal(cfg, p["block0"], a1_raw)
    x = _decoder_layer_stack(p, cfg, x, a1_sig, pos, cache["blocks"], plan,
                             block_tables=None)
    return _logits(p, cfg, x), cache


def decode_step(params, cfg, batch, cache, plan=None):
    """One token a lane against the contiguous cache (``init_cache``):
    batch {"tokens" (B, 1), "pos" (B,)} -> (logits (B, 1, V), cache updated
    in place).  ``plan`` may carry ``dual_branch`` (fal / parallel /
    ablation2 only); a sharded plan raises, as the paged ticks do."""
    check_supported(cfg)
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.DECODE).validate(cfg)
    _refuse_sharded(plan)
    return _decoder_decode(params, cfg, batch, cache, plan)


# ------------------------------------------------------------------------- #
# paged cache and the paged ticks
# ------------------------------------------------------------------------- #
def init_paged_cache(cfg, num_pages, page_size, slots, dtype="bfloat16",
                     kv_dtype="", device=None):
    """Paged KV cache: block 0's (P, page, Hkv, Dh) pools, one
    (n_layers - 1, P, page, Hkv, Dh) tensor per K and per V for the other
    layers, and the per-slot FAL signal (slots, d_model) in ``dtype``.  Page
    0 is scratch.  ``kv_dtype`` selects the page format
    (``attention.gqa_init_paged_cache``); int8 / fp8 pools come with
    (P, page) fp32 ``k_scale`` / ``v_scale`` pools, stacked likewise."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = _dtype(dtype)
    c0 = A.gqa_init_paged_cache(cfg, num_pages, page_size, dt, device,
                                kv_dtype=kv_dtype)
    return {**_stacked(cfg, c0),
            "a1_sig": torch.zeros((slots, cfg.d_model), dtype=dt,
                                  device=device)}


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
    from ``layer_kinds``; the MoE layers' aux is not used when serving."""
    wsched = BL.window_schedule(cfg)[1:]
    kinds = layer_kinds(cfg)[1:]
    for i, pb in enumerate(p["blocks"][:limit]):
        layer_cache = {k: v[i] for k, v in blocks_cache.items()}
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
    x = _embed_tokens(p, cfg, tokens, positions)
    x, a1_raw, _ = BL.block_apply(p["block0"], cfg, x, None,
                                  kind=_layer_kind(cfg, 0), is_block0=True,
                                  plan=plan, cache=cache["block0"],
                                  block_tables=bt, pos=pos, n_valid=n_valid,
                                  window=BL.window_schedule(cfg)[0])
    a1_sig = fal.first_attention_signal(cfg, p["block0"], a1_raw)

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
    return _logits(p, cfg, x), cache


def _decoder_paged_packed(p, cfg, batch, cache, plan, want="logits"):
    """Token-packed ragged tick: tokens (T,), tok_slot (T,), tok_pos (T,)
    (-1 = padding), block_tables (S, Tb), seg_last (S,) index of each
    slot's last packed token (-1 = slot sat the tick out).  Returns
    (logits (1, T, V) or hidden (1, T, D), cache updated in place)."""
    tokens, bt = batch["tokens"], batch["block_tables"]
    tok_slot, tok_pos = batch["tok_slot"], batch["tok_pos"]
    seg_last = batch["seg_last"]
    positions = tok_pos.clamp(min=0)[None]                      # (1, T)
    x = _embed_tokens(p, cfg, tokens[None], positions)
    x, a1_raw, _ = BL.block_apply(p["block0"], cfg, x, None,
                                  kind=_layer_kind(cfg, 0), is_block0=True,
                                  plan=plan, cache=cache["block0"],
                                  block_tables=bt, tok_slot=tok_slot,
                                  tok_pos=tok_pos,
                                  window=BL.window_schedule(cfg)[0])
    a1_sig = fal.first_attention_signal(cfg, p["block0"], a1_raw)

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
    return _logits(p, cfg, x), cache


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
        x, a1_raw, _ = BL.block_apply(p["block0"], cfg, x, None,
                                      kind=_layer_kind(cfg, 0),
                                      is_block0=True, plan=plan,
                                      cache=cache["block0"], block_tables=bt,
                                      tok_slot=tok_slot, tok_pos=tok_pos,
                                      window=BL.window_schedule(cfg)[0])
        a1_sig = fal.first_attention_signal(cfg, p["block0"], a1_raw)
        x = _decoder_layer_stack(p, cfg, x, a1_sig, None, cache["blocks"],
                                 plan, block_tables=bt, tok_slot=tok_slot,
                                 tok_pos=tok_pos, limit=draft_blocks - 1)
    return x, cache


def _refuse_sharded(plan):
    if plan.is_sharded:
        raise NotImplementedError(
            "tensor parallelism in the serving ticks is not ported yet "
            "(ROADMAP.md Queue 1); core.tp.make_tp_decode_step runs one "
            "block's padded decode tick under explicit TP")
    if plan.data_group is not None:
        raise ValueError(
            "a data-parallel group in a serving tick: a data replica is a "
            "separate engine (one per rank), and a tick never reduces over "
            "replicas")


def paged_decode_step(params, cfg, batch, cache, plan=None, want="logits"):
    """One paged tick -> (logits or, with ``want='hidden'``, the pre-head
    hidden states; cache updated in place) in either paged layout:

      * token-packed (the serving engine's tick; the batch carries
        ``tok_slot``): see ``_decoder_paged_packed``; (1, T, V) / (1, T, D);
      * padded chunk (tokens (B, C) with per-lane ``pos`` / ``n_valid``):
        see ``_decoder_paged_decode``; (B, C, V) / (B, C, D).

    ``plan`` may carry ``dual_branch`` (fal / parallel / ablation2 only).
    Tensor parallelism in the paged engine is not ported (ROADMAP.md Queue
    1): a sharded plan raises; ``core.tp.make_tp_decode_step`` runs one
    block's tick under TP."""
    check_supported(cfg)
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.PAGED).validate(cfg)
    _refuse_sharded(plan)
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
    if not 1 <= draft_blocks < cfg.n_layers:
        raise ValueError(
            f"draft_blocks={draft_blocks} must satisfy 1 <= draft_blocks "
            f"< n_layers={cfg.n_layers} (== n_layers would be the full "
            f"model, not a draft)")
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.PAGED).validate(cfg)
    _refuse_sharded(plan)
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

    ``src`` / ``dst`` are host sequences of page ids.  One
    ``ops.copy_page_leaves`` call for every pool leaf: block 0's pools as
    they are, the stacked (L-1, P, ...) pools in every layer (one kernel
    launch for the whole cache on the card; the reference makes one
    ``ops.copy_pages`` call a leaf, with the ids offset per layer).
    ``a1_sig`` is per slot, not per page: untouched.  Returns the cache."""
    ops.copy_page_leaves(
        [(pool, False) for pool in cache["block0"].values()]
        + [(pool, True) for pool in cache["blocks"].values()], src, dst)
    return cache
