"""Rank-side code of the port's data-parallel and gradient-compression
tests (``test_torch_dp.py``, ``test_torch_grad_compress.py``): each
function runs in every rank spawned by ``repro_torch.core.tp.run_ranks``
and returns plain tensors and numbers for the test process to compare.  It
imports neither JAX nor the JAX package (the ranks never run JAX), so it is
a module of its own and not a test file."""
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan
from repro_torch.data.pipeline import shard_rows
from repro_torch.launch import mesh as MX
from repro_torch.models import model as M
from repro_torch.optim import adamw as TO
from repro_torch.optim import grad_compress as GC
from repro_torch.train import checkpoint as CK
from repro_torch.train import step as TT
from repro_torch.train import trainer

from torch_tp_ranks import _shard, tp_config

#: the exchanges ``test_torch_grad_compress.py`` holds against the
#: reference's, by name
PRIMITIVES = {"int8_allreduce": GC._int8_allreduce,
              "lowrank_allreduce": GC._lowrank_allreduce,
              "int8_allgather": GC._int8_allgather,
              "lowrank_allgather": GC._lowrank_allgather}


def dp_plan(groups, **kw):
    """The plan of a ``Groups(tp, dp)`` world: explicit TP where the TP
    axis has ranks, and the data group."""
    return ExecutionPlan.from_group(
        groups.tp, tp="explicit" if groups.tp is not None else "none",
        data_group=groups.dp, **kw)


def _clone(tree):
    return TO.map_tree(lambda t: t.detach().clone()
                       if isinstance(t, torch.Tensor) else t, tree)


def _equal(a, b):
    la, lb = dict(TO.named_leaves(a)), dict(TO.named_leaves(b))
    return la.keys() == lb.keys() and all(
        torch.equal(la[k], lb[k]) if isinstance(la[k], torch.Tensor)
        else la[k] == lb[k] for k in la)


def _steps(cfg, plan, ocfg, np_params, toks, nm):
    """``len(toks)`` train steps of this rank's rows at ``nm``
    microbatches -> (state, [metrics], [collective counts])."""
    params = _shard(np_params, cfg, plan.tp_rank, plan.tp_size)
    state = TT.init_state(0, cfg, ocfg, params=params)
    step = TT.make_train_step(cfg, ocfg, plan, nm)
    metrics, counts = [], []
    for t in toks:
        b = shard_rows({"tokens": t}, plan.dp_rank, plan.dp_size)
        tp.reset_collectives()
        state, m = step(state, {"tokens": torch.from_numpy(b["tokens"])})
        counts.append(tp.collective_counts())
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, counts


def dp_world(groups, np_params, toks, ocfg_kw, ckpt_dir, trainer_kw):
    """Train steps at 1 and 2 microbatches, the checkpoint round trip
    (with ``ckpt_dir``) and ``trainer.train`` (``trainer_kw``) on this
    rank of a tp x dp world; ``toks`` holds one more global batch than
    the steps, for the step after the restore."""
    plan = dp_plan(groups)
    cfg = tp_config("fal")
    ocfg = TO.AdamWConfig(**ocfg_kw)
    out = {"rank": dist.get_rank(), "tp_rank": plan.tp_rank,
           "dp_rank": plan.dp_rank, "tp_size": plan.tp_size,
           "dp_size": plan.dp_size}
    for nm in (1, 2):
        state, metrics, counts = _steps(cfg, plan, ocfg, np_params,
                                        toks[:-1], nm)
        out[nm] = {"metrics": metrics, "counts": counts,
                   "params": _clone(state["params"]),
                   "n_local": sum(p.numel() for _, p in
                                  TO.named_leaves(state["params"]))}
        if nm == 1:
            kept = state
    if ckpt_dir is not None:
        out["ckpt"] = _checkpoint(kept, cfg, plan, ocfg, ckpt_dir, toks[-1])
    _, hist = trainer.train(cfg, plan=plan, device="cpu", log_every=1,
                            **trainer_kw)
    out["trainer"] = [(h["loss"], h["grad_norm"]) for h in hist]
    return out


def _checkpoint(state, cfg, plan, ocfg, ckpt_dir, toks):
    """Save under the plan, restore into this rank's shards, and one more
    step from the restored state and from the state itself."""
    before = _clone(state)
    CK.save_distributed(ckpt_dir, state, cfg, plan, step=3,
                        meta={"arch": cfg.arch_id})
    restored = CK.restore_sharded(ckpt_dir, state, cfg, plan)
    res = {"state": before, "restored_equal": _equal(restored, before),
           "requires_grad": all(p.requires_grad for _, p in
                                TO.named_leaves(restored["params"]))}
    step = TT.make_train_step(cfg, ocfg, plan)
    batch = {"tokens": torch.from_numpy(
        shard_rows({"tokens": toks}, plan.dp_rank, plan.dp_size)["tokens"])}
    a, ma = step(restored, batch)
    b, mb = step(state, batch)
    res["step_equal"] = _equal(a, b) and float(ma["loss"]) == float(
        mb["loss"])
    return res


def primitives(group, inputs):
    """Each exchange of ``PRIMITIVES`` on this rank's slice of every input
    ({name: (n, ...) numpy}) -> {(exchange, input): output}, and the counts
    of each call."""
    r = group.rank()
    out = {}
    for pname, fn in PRIMITIVES.items():
        for iname, x in inputs.items():
            if pname.endswith("allgather") != iname.startswith("gather"):
                continue
            tp.reset_collectives()
            out[(pname, iname)] = fn(torch.from_numpy(x[r]), group)
            out[(pname, iname, "counts")] = tp.collective_counts()
    return out


def _stack_grads(np_blocks, cfg, plan, x, positions):
    """Forward + backward of ``sum(y ** 2)`` through ``decoder_stack_tp``
    on this rank's shard of the reference's block weights -> (this rank's
    gradients after ``tp_sync_grads``, dx, forward counts, backward
    counts)."""
    full = interop.params_from_numpy(np_blocks, cfg, "cpu", dtype="float32")
    shard = MX.shard_params(full, cfg, plan.tp_rank, plan.tp_size)
    for _, p in TO.named_leaves(shard):
        p.requires_grad_(True)
    x = x.clone().requires_grad_(True)
    tp.reset_collectives()
    y = M.decoder_stack_tp(shard, cfg, x, positions, plan)[0]
    fwd = tp.collective_counts()
    tp.reset_collectives()
    (y * y).sum().backward()
    bwd = tp.collective_counts()
    M.tp_sync_grads(shard, cfg, plan)
    grads = TO.map_tree(lambda p: p.grad.detach().clone(), shard)
    return grads, x.grad.detach().clone(), fwd, bwd


def compressed_stack(group, np_blocks, x, mode, methods):
    """The reference's motivation measurement on the port: a 2-layer
    ``tp.bench_stack_config`` stack (d 64, d_ff 256, 8 heads) on the
    reference's weights, replicated and SP, per method of ``methods``."""
    cfg = tp.bench_stack_config(2, 64, 256, 8, mode)
    x = torch.from_numpy(x)
    B, S = x.shape[:2]
    positions = torch.arange(S)[None].expand(B, S)
    out = {}
    for sp in (False, True):
        for m in methods:
            plan = ExecutionPlan.from_group(group, tp="explicit", sp=sp,
                                            grad_compress=m).validate(cfg)
            grads, dx, fwd, bwd = _stack_grads(np_blocks, cfg, plan, x,
                                               positions)
            out[(m, sp)] = {"grads": grads, "dx": dx, "forward": fwd,
                            "backward": bwd}
    return out


def gc_world(group, inputs, np_blocks, x, mode, methods):
    return {"primitives": primitives(group, inputs),
            "stack": compressed_stack(group, np_blocks, x, mode, methods)}
