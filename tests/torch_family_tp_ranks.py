"""Rank-side code of the port's tensor-parallel tests of the ssm, hybrid and
audio families (``test_torch_family_tp.py``): each function runs in every
rank spawned by ``repro_torch.core.tp.run_ranks`` and returns plain tensors
and numbers for the test process to compare.  It imports neither JAX nor
the JAX package (the ranks never run JAX), so it is a module of its own and
not a test file."""
import torch

from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan
from repro_torch.launch import mesh as MX
from repro_torch.models import model as M
from repro_torch.optim import adamw as TO
from repro_torch.serve import decode as SD
from repro_torch.train import step as TT

from torch_dp_ranks import _clone, dp_plan


def family_config(arch, **kw):
    """The reduced ``arch`` (fp32, remat off) with ``kw`` replaced."""
    return get_config(arch).reduced().replace(**kw)


def _shard(np_params, cfg, plan, grad=True):
    """This rank's TP shard of the reference's weights (and, under
    ``plan.fsdp``, its FSDP slices of it)."""
    params = interop.params_from_numpy(np_params, cfg, "cpu",
                                       dtype="float32")
    params = MX.shard_params(params, cfg, plan.tp_rank, plan.tp_size)
    if plan.fsdp:
        params = MX.shard_fsdp(params, cfg, plan.dp_rank, plan.dp_size,
                               plan.tp_size)
    for _, p in TO.named_leaves(params):
        p.requires_grad_(grad)
    return params


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _parity(cfg, plan, np_params, batch, ocfg):
    """Logits (no-grad forward), loss and this rank's gradients after the
    train step's sync, one AdamW step's params and metrics, and the
    collective counts of the forward and of forward + backward + sync."""
    shard = _shard(np_params, cfg, plan)
    tp.reset_collectives()
    with torch.no_grad():
        logits = M.forward(shard, cfg, batch, plan)[0]
    fwd = tp.collective_counts()
    tp.reset_collectives()
    loss, _ = M.loss_fn(shard, cfg, batch, plan)
    loss.backward()
    M.tp_sync_grads(shard, cfg, plan)
    train = tp.collective_counts()
    grads = TO.map_tree(lambda p: p.grad.detach().clone(), shard)
    state = TT.init_state(0, cfg, ocfg, params=_shard(np_params, cfg, plan))
    state, m = TT.make_train_step(cfg, ocfg, plan)(state, batch)
    return {"logits": logits, "loss": float(loss), "grads": grads,
            "forward": fwd, "train": train, "step": _clone(state["params"]),
            "step_metrics": {k: float(v) for k, v in m.items()}}


def _decode(cfg, plan, np_params, prompt, frames, ticks):
    """``ticks`` greedy ``make_serve_step`` ticks under ``plan`` from
    ``prompt`` (B,) at position 0 (whisper's cache filled by
    ``whisper_encode`` of ``frames`` first) -> the tokens (B, ticks), the
    logits and each tick's collective counts (and the encoder's)."""
    shard = _shard(np_params, cfg, plan, grad=False)
    B = prompt.shape[0]
    cache = M.init_cache(cfg, B, ticks + 2, "float32", device="cpu",
                         tp_size=plan.tp_size)
    out = {"cache_shapes": {p: tuple(t.shape) for p, t in
                            TO.named_leaves(cache)}}
    if frames is not None:
        tp.reset_collectives()
        with torch.no_grad():
            cache["enc_out"].copy_(M.whisper_encode(shard, cfg, frames,
                                                    plan))
        out["encode"] = tp.collective_counts()
    step = SD.make_serve_step(cfg, plan)
    tok = prompt[:, None]
    toks, logits, counts = [], [], []
    for t in range(ticks):
        tp.reset_collectives()
        nxt, lg, cache = step(shard, cache, tok,
                              torch.full((B,), t, dtype=torch.int32))
        counts.append(tp.collective_counts())
        toks.append(nxt)
        logits.append(lg)
        tok = nxt[:, None]
    out.update(tokens=torch.stack(toks, 1), logits=torch.cat(logits, 1),
               counts=counts)
    return out


def _batcher(cfg, plan, np_params, reqs, slots, max_seq):
    """A ``ContinuousBatcher`` a rank in lockstep over ``reqs`` ((rid,
    prompt, max_new)) -> {rid: generated}, and the ticks' counts."""
    shard = _shard(np_params, cfg, plan, grad=False)
    eng = SD.ContinuousBatcher(cfg, shard, batch_slots=slots,
                               max_seq=max_seq, plan=plan, device="cpu")
    for rid, prompt, max_new in reqs:
        eng.submit(SD.Request(rid=rid, prompt=prompt, max_new=max_new))
    tp.reset_collectives()
    done = {r.rid: r.generated for r in eng.run()}
    return {"streams": done, "ticks": eng.ticks,
            "counts": tp.collective_counts()}


def family_parity(group, cases, ocfg_kw, ticks, batchers):
    """Every case {name: (config kwargs of ``family_config``, reference
    weights, numpy batch, prompt (B,))}: the parity run and the greedy
    decode; then each batcher case {name: (config kwargs, weights,
    requests, slots, max_seq)}."""
    plan = ExecutionPlan.from_group(group, tp="explicit")
    ocfg = TO.AdamWConfig(**ocfg_kw)
    out = {"rank": group.rank()}
    for name, (kw, np_params, batch, prompt) in cases.items():
        cfg = family_config(**kw)
        batch = _torch_batch(batch)
        out[name] = _parity(cfg, plan, np_params, batch, ocfg)
        out[name]["decode"] = _decode(cfg, plan, np_params,
                                      torch.from_numpy(prompt),
                                      batch.get("frames"), ticks)
    for name, (kw, np_params, reqs, slots, max_seq) in batchers.items():
        out[f"batcher_{name}"] = _batcher(family_config(**kw), plan,
                                          np_params, reqs, slots, max_seq)
    return out


def family_fsdp(groups, kw, np_params, toks, ocfg_kw, steps, floor):
    """tp x dp FSDP train steps of this rank's rows (the global batch of
    each step in ``toks``) -> the metrics, this rank's slices' gradients
    of the first step (after every sum, before the clip) and the params
    after the steps, with the rank's coordinates."""
    MX.FSDP_MIN_DIM = floor
    plan = dp_plan(groups, fsdp=True)
    cfg = family_config(**kw)
    ocfg = TO.AdamWConfig(**ocfg_kw)
    grads = []

    def on_grads(params):
        if not grads:
            grads.append(TO.map_tree(lambda p: p.grad.detach().clone(),
                                     params))
    state = TT.init_state(0, cfg, ocfg, params=_shard(np_params, cfg, plan))
    step = TT.make_train_step(cfg, ocfg, plan, on_grads=on_grads)
    rows = toks.shape[1] // plan.dp_size
    metrics = []
    for t in toks[:steps]:
        mine = t[plan.dp_rank * rows:(plan.dp_rank + 1) * rows]
        state, m = step(state, {"tokens": torch.from_numpy(mine)})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"tp_rank": plan.tp_rank, "dp_rank": plan.dp_rank,
            "tp_size": plan.tp_size, "dp_size": plan.dp_size,
            "metrics": metrics, "grads": grads[0],
            "params": _clone(state["params"])}
