"""Rank-side code of ``test_torch_tp_serving.py``: every function runs in
each rank spawned by ``repro_torch.core.tp.run_ranks`` over an
explicit-TP plan, on this rank's shard of the reference's numpy weights and
this rank's KV heads of the given caches, and returns plain tensors, token
streams and collective counts for the test process to compare.  It imports
neither JAX nor the JAX package (the ranks never run JAX), so it is a
module of its own and not a test file."""
import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan, local_kv_heads
from repro_torch.launch import mesh as MX
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.serve import decode as D
from repro_torch.serve import sampling as SP
from repro_torch.serve import scheduler as S

from torch_tp_ranks import tp_config


def kv_heads(cfg, rank, size):
    """The KV heads rank ``rank`` holds: a slice of the head axis (with
    n_kv_heads < tp, the one its query heads attend)."""
    hk = local_kv_heads(cfg, size)
    h0 = rank * hk if cfg.n_kv_heads % size == 0 \
        else rank // (size // cfg.n_kv_heads)
    return slice(h0, h0 + hk)


def local_cache(np_cache, cfg, rank, size):
    """A full-head numpy cache (the reference's layout) -> this rank's
    torch cache: K / V pools cut to its heads, scale pools and a1_sig
    whole."""
    full = interop.cache_from_numpy(np_cache, "cpu")
    heads = kv_heads(cfg, rank, size)
    out = {}
    for part, leaves in full.items():
        if not isinstance(leaves, dict):
            out[part] = leaves.clone()
            continue
        out[part] = {k: (v[..., heads, :].clone() if k in ("k", "v")
                         else v.clone()) for k, v in leaves.items()}
    return out


def _shard(np_params, cfg, rank, size):
    full = interop.params_from_numpy(np_params, cfg, "cpu", dtype="float32")
    return MX.shard_params(full, cfg, rank, size)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _counted(fn):
    tp.reset_collectives()
    with torch.no_grad():
        out = fn()
    return out, tp.collective_counts()


class RecordingEngine(S.PagedEngine):
    """The engine, recording each model call's pack and the collectives
    it paid."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.packs, self.tick_counts = [], []

    def _run_packed(self, pt):
        self.packs.append(np.stack([pt.tokens, pt.tok_slot, pt.tok_pos]))
        tp.reset_collectives()
        super()._run_packed(pt)
        self.tick_counts.append(tp.collective_counts())


def _sampling(s):
    return SP.SamplingParams(**s) if s else SP.SamplingParams()


def run_engine(cfg, params, plan, ecfg_kw, phases):
    """``phases``: lists of (rid, prompt, max_new, sampling kwargs), each
    submitted and run to the end before the next -> ({rid: stream}, stats,
    packs, per-call counts)."""
    eng = RecordingEngine(cfg, params, S.EngineConfig(**ecfg_kw), plan=plan,
                          device="cpu")
    for reqs in phases:
        for rid, prompt, max_new, samp in reqs:
            eng.submit(S.ServeRequest(rid=rid, prompt=np.asarray(prompt),
                                      max_new=max_new,
                                      sampling=_sampling(samp)))
        eng.run()
    st = eng.stats()
    return {"streams": {r.rid: list(map(int, r.generated))
                        for r in eng.finished},
            "preemptions": st["preemptions"],
            "cow": (st["prefix"] or {}).get("cow_copies", 0),
            "hits": (st["prefix"] or {}).get("hit_rate", 0.0),
            "packs": eng.packs, "counts": eng.tick_counts}


def serve(group, cases, inputs):
    """Every serving path under ``ExecutionPlan.from_group(group,
    tp="explicit")``; ``cases`` {name: (tp_config kwargs, numpy weights)},
    ``inputs`` the test's batches, caches and workloads."""
    rank, size = group.rank(), group.size()
    plan = ExecutionPlan.from_group(group, tp="explicit")
    shards = {name: (tp_config(**kw), _shard(w, tp_config(**kw), rank, size))
              for name, (kw, w) in cases.items()}
    out = {}

    # (a) packed ticks on a cache with history
    for name, (batch, np_cache) in inputs["packed"].items():
        cfg, shard = shards[name]
        cache = local_cache(np_cache, cfg, rank, size)
        logits, counts = _counted(lambda: M.paged_decode_step(
            shard, cfg, _tensors(batch), cache, plan)[0])
        out[("packed", name)] = {"logits": logits, "cache": cache,
                                 "counts": counts}

    # (b) padded chunk and C == 1 ticks, sequential and dual
    for (name, C, dual), (batch, np_cache) in inputs["padded"].items():
        cfg, shard = shards[name]
        cache = local_cache(np_cache, cfg, rank, size)
        p = plan.with_dual_branch(dual)
        logits, counts = _counted(lambda: M.paged_decode_step(
            shard, cfg, _tensors(batch), cache, p)[0])
        out[("padded", name, C, dual)] = {"logits": logits,
                                          "counts": counts}

    # (c) contiguous decode ticks and the batcher
    for (name, dual), (toks, ticks) in inputs["contiguous"].items():
        cfg, shard = shards[name]
        p = plan.with_dual_branch(dual)
        cache = M.init_cache(cfg, toks.shape[0], toks.shape[1], "float32",
                             device="cpu", tp_size=size)
        logits, counts = [], []
        for pos in ticks:
            batch = {"tokens": torch.from_numpy(
                toks[np.arange(toks.shape[0]), list(pos)][:, None]),
                "pos": torch.tensor(pos, dtype=torch.int32)}
            lg, c = _counted(lambda: M.decode_step(shard, cfg, batch, cache,
                                                   p)[0])
            logits.append(lg[:, 0])
            counts.append(c)
        out[("contiguous", name, dual)] = {
            "logits": torch.stack(logits), "counts": counts,
            "heads": cache["block0"]["k"].shape[2]}
    for name, (slots, max_seq, reqs) in inputs["batcher"].items():
        cfg, shard = shards[name]
        cb = D.ContinuousBatcher(cfg, shard, slots, max_seq, plan=plan,
                                 device="cpu")
        for rid, prompt, max_new in reqs:
            cb.submit(D.Request(rid=rid, prompt=prompt, max_new=max_new))
        out[("batcher", name)] = {r.rid: r.generated for r in cb.run()}

    # (d, e) engines
    for key, (name, ecfg_kw, phases) in inputs["engines"].items():
        cfg, shard = shards[name]
        out[("engine", key)] = run_engine(cfg, shard, plan, ecfg_kw, phases)

    # (e) quantized pages: packed ticks from empty pools, and the
    # scatter alone on given K / V
    for (name, kv), batches in inputs["quantized"].items():
        cfg, shard = shards[name]
        cache = M.init_paged_cache(cfg, *inputs["quant_pool"], "float32",
                                   kv_dtype=kv, device="cpu", tp_size=size)
        for batch in batches:
            _, counts = _counted(lambda: M.paged_decode_step(
                shard, cfg, _tensors(batch), cache, plan))
        out[("quantized", name, kv)] = {"cache": cache, "counts": counts}
    for kv, (k, v, pool) in inputs["scatter"].items():
        cfg = shards["fal"][0]
        heads = kv_heads(cfg, rank, size)
        cache = A.gqa_init_paged_cache(cfg, pool, 4, torch.float32, "cpu",
                                       kv_dtype=kv,
                                       n_kv_heads=heads.stop - heads.start)
        kk, vv = (torch.from_numpy(a[:, heads]) for a in (k, v))
        slots = torch.arange(k.shape[0])
        tables = (1 + torch.arange(pool - 1, dtype=torch.int32))[None]
        _, counts = _counted(lambda: A._scatter_kv(
            cache, kk, vv, lambda p_, vals: A.packed_scatter(
                p_, vals, tables, torch.zeros_like(slots, dtype=torch.int32),
                slots.to(torch.int32), 4), plan.inner()))
        out[("scatter", kv)] = {"cache": cache, "counts": counts}
    return out


def drift(group):
    """A rank out of step: its all-reduce has another shape than its
    peer's (as a rank whose host decisions differed would send)."""
    t = torch.ones(4 + group.rank())
    tp.all_reduce(t, group, "forward")
    return float(t.sum())
