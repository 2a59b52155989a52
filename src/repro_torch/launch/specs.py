"""One rank's model inputs as ``meta`` tensors: the sharded train state,
the rank's batch rows and its decode cache, with no device memory.  This is
what the dry run (``launch/dryrun.py``) runs a step against.

Port of ``repro/launch/specs.py:26-108``.  The reference builds
``ShapeDtypeStruct``s of the GLOBAL arrays with shardings over a mesh; here
a rank is a process, so each function returns that rank's own tensors:
its shard of the blocks (``launch/mesh.py`` ``shard_params``) and, with
``fsdp`` (the reference's default ``fsdp_axes``), its FSDP slices of them
(``shard_fsdp``), its rows of the batch and its slice of the decode cache
by the reference's ``cache_specs`` (``launch/mesh.py``): its rows, KV
heads and positions, with tokens and positions cut over the data axes
only where the batch divides them (the reference's ``bspec``; long_500k's
batch of 1 never does).  ``tp`` is the model
axis's size and ``dp`` the data axes' (pod x data); every rank's slices
have one size (the last rank's FSDP slices are padded; the cache is never
cut unevenly), so rank 0 stands for all.
"""
from __future__ import annotations

import torch

from repro_torch.launch import mesh as MX
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

META = torch.device("meta")


def dryrun_overrides(cfg, shape_cfg):
    """Numerics / memory policy of full-scale dry runs (reference
    ``:26-34``): bf16 compute; bf16 params for deepseek (the 671B fits
    nowhere otherwise), fp32 masters for the rest."""
    over = dict(dtype="bfloat16")
    if cfg.arch_id.startswith("deepseek"):
        over.update(param_dtype="bfloat16")
    else:
        over.update(param_dtype="float32")
    return cfg.replace(**over)


def opt_cfg_for(cfg):
    """AdamW at lr 1e-4 with bf16 moments for deepseek, fp32 for the rest
    (reference ``:37-41``)."""
    return adamw.AdamWConfig(
        lr=1e-4,
        state_dtype="bfloat16" if cfg.arch_id.startswith("deepseek")
        else "float32")


def num_microbatches(cfg, shape_cfg, dp, override=None):
    """Microbatches of a train step (reference ``:44-55``): 8 for MoE or d
    >= 4096, else 4, halved until a microbatch of the global batch still
    covers the ``dp`` data ranks; 1 for other modes.  ``override`` (the
    reference's ``REPRO_MICROBATCHES``) wins for train shapes."""
    if shape_cfg.mode != "train":
        return 1
    if override:
        return int(override)
    big = cfg.n_experts > 0 or cfg.d_model >= 4096
    n = 8 if big else 4
    while shape_cfg.global_batch // n < dp and n > 1:
        n //= 2
    return n


def batch_rows(global_batch, dp):
    """A rank's rows of a train or prefill batch: the global batch split
    over the ``dp`` data ranks, ceil(B / dp) of them (a batch smaller than
    the data axes, as prefill_32k's 32 rows at whisper's 64 or 128 data
    ranks, gives its first B ranks one row each and leaves the rest idle,
    where the reference cuts the batch over the data axes all the
    same).  A decode batch follows the cache: ``decode_rows``."""
    return -(-global_batch // dp)


def decode_rows(global_batch, dp):
    """A rank's rows of a decode batch (the reference's ``bspec``,
    ``specs.py:101-107``): B / dp when the batch divides the data ranks,
    else the whole batch on every rank, whose KV sequence is then cut over
    the data ranks (``launch/mesh.py::cache_specs``)."""
    return global_batch // dp if global_batch % dp == 0 else global_batch


def batch_struct(cfg, shape_cfg, dp):
    """A rank's input batch for the shape (reference ``:58-74``): int32
    tokens (rows, S), and outside decode a VLM's bf16 ``image_embeds``
    (rows, n_image_tokens, d) or whisper's bf16 ``frames`` (rows,
    n_enc_frames, d)."""
    B, S = batch_rows(shape_cfg.global_batch, dp), shape_cfg.seq_len
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    if cfg.family == "vlm" and shape_cfg.mode != "decode":
        out["image_embeds"] = torch.empty(
            (B, cfg.n_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=META)
    if cfg.family == "audio" and shape_cfg.mode != "decode":
        out["frames"] = torch.empty((B, cfg.n_enc_frames, cfg.d_model),
                                    dtype=torch.bfloat16, device=META)
    return out


def _params(cfg, tp, tp_rank, dp=1, fsdp=False):
    """The rank's parameters in ``cfg.param_dtype``: the whole tree, or
    under TP (tp > 1) its shard of the blocks; with ``fsdp`` its data
    rank 0's FSDP slices of those over ``dp`` ranks."""
    params = M.init_params(cfg, device=META, dtype=cfg.param_dtype)
    if tp > 1:
        params = MX.shard_params(params, cfg, tp_rank, tp)
    if fsdp:
        params = MX.shard_fsdp(params, cfg, 0, dp, tp)
    return params


def train_input_specs(cfg, shape_cfg, tp=1, dp=1, tp_rank=0, fsdp=False):
    """(state, batch) of one rank for ``make_train_step`` (reference
    ``:77-86``): the params' shard (with ``fsdp``, its slices) with
    AdamW's moments (``opt_cfg_for``) of the same shapes, and the rank's
    batch rows."""
    state = tstep.init_state(0, cfg, opt_cfg_for(cfg),
                             params=_params(cfg, tp, tp_rank, dp, fsdp))
    return state, batch_struct(cfg, shape_cfg, dp)


def decode_input_specs(cfg, shape_cfg, tp=1, dp=1, tp_rank=0, fsdp=False,
                       cache_dtype="bfloat16"):
    """(params, cache, tokens, pos) of one rank for ``make_serve_step``
    (reference ``:89-108``): the params' shard (in ``cfg.param_dtype``, as
    the reference lowers them; with ``fsdp``, its slices), its slice of a
    contiguous cache in ``cache_dtype`` (bf16, as the reference's) by
    ``cache_specs`` at the global batch (``init_cache(..., tp_size=,
    dp_size=)``), and int32 tokens (rows, 1) and positions (rows,) of its
    ``decode_rows``."""
    B = decode_rows(shape_cfg.global_batch, dp)
    params = _params(cfg, tp, tp_rank, dp, fsdp)
    cache = M.init_cache(cfg, shape_cfg.global_batch, shape_cfg.seq_len,
                         cache_dtype, device=META, tp_size=tp, dp_size=dp)
    tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
    pos = torch.empty((B,), dtype=torch.int32, device=META)
    return params, cache, tokens, pos
