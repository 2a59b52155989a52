"""Rank-side code of the port's tensor-parallel tests
(``test_torch_tp.py``, ``test_torch_tp_structure.py``): each function runs
in every rank spawned by ``repro_torch.core.tp.run_ranks`` and returns
plain tensors and numbers for the test process to compare.  It imports
neither JAX nor the JAX package (the ranks never run JAX), so it is a
module of its own and not a test file."""
import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan, Phase, local_kv_heads
from repro_torch.launch import mesh as MX
from repro_torch.models import attention as A
from repro_torch.models import blocks as BL
from repro_torch.models import model as M
from repro_torch.optim import adamw as TO
from repro_torch.train import step as TT

MODES = ("preln", "fal", "parallel", "falplus", "ablation1", "ablation2")


def tp_config(connection, arch="llama3.2-3b", **kw):
    """The reduced ``arch`` (llama3.2-3b) at 4 layers (fp32, remat off)."""
    return get_config(arch).reduced().replace(
        connection=connection, n_layers=4, **kw)


def _shard(np_params, cfg, rank, tp_size):
    full = interop.params_from_numpy(np_params, cfg, "cpu", dtype="float32")
    shard = MX.shard_params(full, cfg, rank, tp_size)
    for _, p in TO.named_leaves(shard):
        p.requires_grad_(True)
    return shard


def _forward_backward(shard, cfg, plan, toks):
    """-> (logits, loss, this rank's gradients after the train step's sync,
    collective counts of the no-grad forward, of forward + backward + the
    sync)."""
    batch = {"tokens": toks}
    tp.reset_collectives()
    with torch.no_grad():
        logits = M.forward(shard, cfg, batch, plan)[0]
    fwd = tp.collective_counts()
    for _, p in TO.named_leaves(shard):
        p.grad = None
    tp.reset_collectives()
    loss, _ = M.loss_fn(shard, cfg, batch, plan)
    loss.backward()
    M.tp_sync_grads(shard, cfg, plan)
    train = tp.collective_counts()
    grads = TO.map_tree(lambda p: p.grad.detach().clone(), shard)
    return logits, float(loss), grads, fwd, train


def parity(group, cases, toks, train_case):
    """For each case {name: (config kwargs of ``tp_config``, reference
    weights)}, TP and TP + SP logits, loss and gradients; and two train
    steps."""
    rank, size = torch.distributed.get_rank(), group.size()
    toks = torch.from_numpy(toks)
    out = {}
    for name, (kw, np_params) in cases.items():
        cfg = tp_config(**kw)
        for sp in (False, True):
            plan = ExecutionPlan.from_group(group, tp="explicit", sp=sp)
            logits, loss, grads, _, _ = _forward_backward(
                _shard(np_params, cfg, rank, size), cfg, plan, toks)
            out[(name, sp)] = {"logits": logits, "loss": loss,
                               "grads": grads}
    out["train"] = _train(group, *train_case)
    return out


def _train(group, np_params, toks, ocfg_kw, steps):
    rank, size = torch.distributed.get_rank(), group.size()
    cfg = tp_config("fal")
    ocfg = TO.AdamWConfig(**ocfg_kw)
    plan = ExecutionPlan.from_group(group, tp="explicit")
    state = TT.init_state(0, cfg, ocfg,
                          params=_shard(np_params, cfg, rank, size))
    step = TT.make_train_step(cfg, ocfg, plan)
    metrics = []
    for i in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(toks[i])})
        metrics.append({k: float(v) for k, v in m.items()})
    params = TO.map_tree(lambda p: p.detach().clone(), state["params"])
    return {"params": params, "metrics": metrics}


def structure(group, remat_modes):
    """Collective counts and bytes of the no-grad forward and of forward +
    backward per (mode, sp, remat) at random weights, the replicated and SP
    logits, and (under "decode") ``decode_ticks``."""
    rank, size = torch.distributed.get_rank(), group.size()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 16)).astype(np.int32))
    out = {}
    cases = [(m, sp, False) for m in MODES for sp in (False, True)]
    cases += [(m, False, True) for m in remat_modes]
    for mode, sp, remat in cases:
        cfg = tp_config(mode, remat=remat)
        full = M.init_params(cfg, seed=3, device="cpu", dtype="float32")
        shard = MX.shard_params(full, cfg, rank, size)
        for _, p in TO.named_leaves(shard):
            p.requires_grad_(True)
        plan = ExecutionPlan.from_group(group, tp="explicit", sp=sp)
        logits, _, _, fwd, train = _forward_backward(shard, cfg, plan, toks)
        out[(mode, sp, remat)] = {"logits": logits, "forward": fwd,
                                  "train": train}
    out["decode"] = decode_ticks(group)
    out["tp_forward"] = tp_forward_vs_replicated(group)
    return out


def tp_forward_vs_replicated(group):
    """``tp.make_tp_forward`` (3 layers, d 64, 8 heads; replicated and SP)
    against the same stack run replicated on one rank: {(mode, sp): max
    |diff|}."""
    x = torch.randn((2, 16, 64), generator=torch.Generator().manual_seed(1))
    positions = torch.arange(16)[None].expand(2, 16)
    out = {}
    for mode in ("preln", "fal"):
        cfg = tp.bench_stack_config(3, 64, 256, 8, mode)
        full = tp._block_stack(cfg, 0, "cpu", torch.float32)
        with torch.no_grad():
            want = M._run_decoder_blocks(full, cfg, x, positions,
                                         ExecutionPlan.single_device())[0]
        for sp in (False, True):
            init_fn, fwd = tp.make_tp_forward(group, 3, 64, 256, 8, mode,
                                              sp=sp)
            with torch.no_grad():
                got = fwd(init_fn(0), x)
            out[(mode, sp)] = float((got - want).abs().max())
    return out


def _random_cache(cfg, num_pages, page, gen):
    shape = (num_pages, page, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {k: torch.randn(shape, generator=gen) for k in ("k", "v")}


def decode_ticks(group):
    """One steady-state block's padded decode tick (sequential and dual)
    under TP on a cache with history, and the one-device tick on the same
    weights and cache; plus the reference's structural gate
    (``tp.assert_dual_no_extra_collectives``)."""
    rank, size = torch.distributed.get_rank(), group.size()
    out = {"gate": tp.assert_dual_no_extra_collectives(group)}
    B, T, page = 2, 4, 8
    gen = torch.Generator().manual_seed(5)
    for mode, kv in (("fal", 2), ("parallel", 2), ("fal", 1)):
        cfg = tp_config(mode, n_kv_heads=kv)
        full = BL.block_init(gen, cfg, torch.float32, "cpu")
        cache = _random_cache(cfg, B * T + 1, page, gen)
        x = torch.randn((B, 1, cfg.d_model), generator=gen)
        sig = torch.randn((B, 1, cfg.d_model), generator=gen)
        bt = torch.arange(1, 1 + B * T, dtype=torch.int32).reshape(B, T)
        pos = torch.tensor([5, 3 * page + 2], dtype=torch.int32)
        nv = torch.ones((B,), dtype=torch.int32)
        hk = local_kv_heads(cfg, size)
        # this rank's KV heads; with n_kv_heads < tp, its group's one
        h0 = rank * hk if cfg.n_kv_heads % size == 0 \
            else rank // (size // cfg.n_kv_heads)
        res = {}
        for dual in (False, True):
            one = {k: v.clone() for k, v in cache.items()}
            plan1 = ExecutionPlan.single_device(Phase.PAGED, dual)
            with torch.no_grad():
                ref, _ = BL.block_apply(full, cfg, x, sig, plan=plan1,
                                        cache=one, block_tables=bt, pos=pos,
                                        n_valid=nv)
            _, step = tp.make_tp_decode_step(group, cfg, dual=dual,
                                             page_size=page)
            local = {k: v[:, :, h0:h0 + hk].clone()
                     for k, v in cache.items()}
            assert A.gqa_init_paged_cache(
                cfg, 1, page, torch.float32, "cpu",
                n_kv_heads=hk)["k"].shape[2] == local["k"].shape[2]
            tp.reset_collectives()
            with torch.no_grad():
                got, local = step(MX.shard_params(full, cfg, rank, size), x,
                                  local, bt, pos, nv, sig)
            res["dual" if dual else "sequential"] = {
                "out": got, "one_device": ref,
                "counts": tp.collective_counts(),
                "cache_err": max(float((local[k] - one[k][
                    :, :, h0:h0 + hk]).abs().max()) for k in local)}
        out[mode if kv == 2 else f"{mode}-kv1"] = res
    return out
