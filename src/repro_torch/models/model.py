"""The dense FAL decoder on torch tensors: parameters, the paged KV cache
and the paged ticks.

Port of the paged serving paths of ``repro/models/model.py``:
``_embed_tokens``, ``_logits`` / ``lm_head``, ``init_paged_cache``
(``:957``), ``paged_decode_step`` (``:979``) -> ``_decoder_paged_packed``
(``:466``, the token-packed layout) or ``_decoder_paged_decode`` (``:388``,
the padded (B, C) layout, sequential or dual-branch), and
``_decoder_layer_stack`` (``:280``), plus ``init_params`` for the dense
decoder.

Parameters are a dict tree in the reference's layout, except that the
stacked ``blocks_dense`` leaves (leading layer axis) become a list of
per-layer dicts under ``"blocks"``.  The cache holds block 0's pools, one
``(n_layers - 1, P, page, Hkv, Dh)`` tensor per K and per V for the other
layers, and the per-slot ``a1_sig``; a tick updates all of them in place.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when there is none.  Pass ``device="cpu"`` to run the plain versions of
the kernels on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fal
from repro_torch.core.plan import ExecutionPlan, Phase
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


def check_supported(cfg):
    """Raise NotImplementedError for what this slice of the port does not
    cover yet, naming the slice that will."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family '{cfg.family}': the PyTorch port serves the dense "
            f"decoder only; MoE, VLM, SSM, hybrid and audio come in the "
            f"family-breadth slices (ROADMAP.md Queue 1)")
    if cfg.use_mla or cfg.n_experts:
        raise NotImplementedError(
            "MLA / MoE layers come in the family-breadth slice of the "
            "PyTorch port")
    if cfg.sliding_window or cfg.attn_softcap or cfg.final_softcap:
        raise NotImplementedError(
            "sliding windows and softcaps come in a later slice of the "
            "PyTorch port (the reference's per-token gather branch)")


def _dtype(name) -> torch.dtype:
    return getattr(torch, name)


# ------------------------------------------------------------------------- #
# parameters
# ------------------------------------------------------------------------- #
def init_params(cfg, seed=0, device=None):
    """Random dense-decoder weights at the reference's scales, drawn with a
    ``torch.Generator`` on ``device`` (not the reference's numbers: tests
    carry JAX weights across with ``interop.params_from_numpy``)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = _dtype(cfg.dtype)
    p = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt, device)}
    if cfg.learned_pos:
        p["pos_emb"] = (torch.randn((cfg.max_seq, cfg.d_model), generator=gen,
                                    device=device) * 0.02).to(dt)
    p["block0"] = BL.block_init(gen, cfg, dt, device, is_block0=True)
    p["blocks"] = [BL.block_init(gen, cfg, dt, device)
                   for _ in range(cfg.n_layers - 1)]
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
# paged cache and the paged ticks
# ------------------------------------------------------------------------- #
def init_paged_cache(cfg, num_pages, page_size, slots, dtype="bfloat16",
                     kv_dtype="", device=None):
    """Paged KV cache: block 0's (P, page, Hkv, Dh) pools, one
    (n_layers - 1, P, page, Hkv, Dh) tensor per K and per V for the other
    layers, and the per-slot FAL signal (slots, d_model).  Page 0 is
    scratch."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = _dtype(dtype)
    c0 = A.gqa_init_paged_cache(cfg, num_pages, page_size, dt, device,
                                kv_dtype=kv_dtype)
    rest = (cfg.n_layers - 1,) + tuple(c0["k"].shape)
    return {
        "block0": c0,
        "blocks": {"k": torch.zeros(rest, dtype=dt, device=device),
                   "v": torch.zeros(rest, dtype=dt, device=device)},
        "a1_sig": torch.zeros((slots, cfg.d_model), dtype=dt, device=device),
    }


def _decoder_layer_stack(p, cfg, x, a1_sig, pos, blocks_cache, plan, *,
                         block_tables, n_valid=None, tok_slot=None,
                         tok_pos=None):
    """The post-block-0 layers as a Python loop (the reference scans).
    Layer i reads and writes the i-th slice of the stacked pools in place,
    where the reference concatenates per-layer caches."""
    for i, pb in enumerate(p["blocks"]):
        layer_cache = {"k": blocks_cache["k"][i], "v": blocks_cache["v"][i]}
        x, _ = BL.block_apply(pb, cfg, x, a1_sig, plan=plan,
                              cache=layer_cache, block_tables=block_tables,
                              pos=pos, n_valid=n_valid, tok_slot=tok_slot,
                              tok_pos=tok_pos)
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
    x, a1_raw = BL.block_apply(p["block0"], cfg, x, None, is_block0=True,
                               plan=plan, cache=cache["block0"],
                               block_tables=bt, pos=pos, n_valid=n_valid)
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
    x, a1_raw = BL.block_apply(p["block0"], cfg, x, None, is_block0=True,
                               plan=plan, cache=cache["block0"],
                               block_tables=bt, tok_slot=tok_slot,
                               tok_pos=tok_pos)
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


def paged_decode_step(params, cfg, batch, cache, plan=None, want="logits"):
    """One paged tick -> (logits or, with ``want='hidden'``, the pre-head
    hidden states; cache updated in place) in either paged layout:

      * token-packed (the serving engine's tick; the batch carries
        ``tok_slot``): see ``_decoder_paged_packed``; (1, T, V) / (1, T, D);
      * padded chunk (tokens (B, C) with per-lane ``pos`` / ``n_valid``):
        see ``_decoder_paged_decode``; (B, C, V) / (B, C, D).

    ``plan`` may carry ``dual_branch`` (fal / parallel / ablation2 only)."""
    check_supported(cfg)
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.PAGED).validate(cfg)
    if "tok_slot" in batch:
        return _decoder_paged_packed(params, cfg, batch, cache, plan,
                                     want=want)
    return _decoder_paged_decode(params, cfg, batch, cache, plan, want=want)
