"""Train step: loss -> grad (with microbatched gradient accumulation) ->
AdamW update, on the port's parameter tree.

Port of ``repro/train/step.py``.  The reference builds a pure function for
``jax.jit``; here ``train_step(state, batch)`` runs eagerly and updates the
state IN PLACE (params, AdamW moments and count) and returns it.  The
gradients land in each leaf's ``.grad`` (fp32, as the fp32 masters are):
with ``num_microbatches > 1`` the microbatches run as a Python loop whose
backward passes accumulate into ``.grad``, the fp32 accumulation buffer,
which is then divided by the count, as the reference's scan sums and
divides.  Batches are dicts of torch tensors on the params' device.

Under a plan with a data-parallel group each rank's batch is its rows of
the global batch (``data.pipeline.shard_rows``); after the backward (the
last microbatch, and ``model.tp_sync_grads`` under TP) every gradient is
summed over the data group in ONE flat all-reduce (direction ``data``)
and divided by its size, exactly: ``grad_compress`` does not touch it, as
in the reference.  The reported loss (and ce / aux) is the data group's
mean (one small all-reduce, direction ``metric``): the global batch's.

Under ``plan.fsdp`` the params and AdamW's moments are this rank's FSDP
slices (``launch/mesh.py::shard_fsdp``, after ``shard_params`` under TP):
each unit gathers its leaves when it runs and its backward reduce-scatters
their gradients into the slices' ``.grad``, once a microbatch (the
reference's ``grad_shardings`` pin), so the flat data all-reduce covers
only the leaves FSDP leaves whole; the global norm sums the slices'
squares over the data group and AdamW updates the slices.
"""
from __future__ import annotations

import torch

from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan, Phase
from repro_torch.launch import mesh as MX
from repro_torch.models import model as M
from repro_torch.optim import adamw


def make_loss_fn(cfg, plan=None):
    plan = ExecutionPlan.resolve(plan)

    def loss(params, batch):
        return M.loss_fn(params, cfg, batch, plan)
    return loss


def _leaves(params):
    return [t for _, t in adamw.named_leaves(params)]


def make_grad_fn(cfg, plan=None, num_microbatches: int = 1):
    """Returns ``grad_fn(params, batch) -> (loss, metrics)``: the train
    step's loss and gradients without the update.  Each leaf's ``.grad``
    holds, afterwards, the gradient of the global batch's mean loss: summed
    over the microbatches and divided, summed over the TP group where each
    rank holds a partial sum (``model.tp_sync_grads``) and averaged over
    the data group (one flat all-reduce).  ``metrics`` as the train
    step's, without ``grad_norm``."""
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.TRAIN)
    plan.validate(cfg)
    loss_fn = make_loss_fn(cfg, plan)
    dgroup, dp = plan.data_group, plan.dp_size
    # leaves whose gradient the FSDP reduce-scatter already summed
    fsdp = fsdp_paths(cfg, plan)

    def grad_fn(params, batch):
        leaves = _leaves(params)
        for p in leaves:
            p.grad = None
        if num_microbatches == 1:
            loss, metrics = loss_fn(params, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            micro = {k: v.reshape((num_microbatches, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = 0.0
            for i in range(num_microbatches):
                l_i, _ = loss_fn(params, {k: v[i] for k, v in micro.items()})
                l_i.backward()
                loss = loss + l_i.detach()
            loss = loss / num_microbatches
            for p in leaves:
                p.grad.div_(num_microbatches)
            metrics = {}
        if plan.use_explicit_tp:
            M.tp_sync_grads(params, cfg, plan)
        if dgroup is not None:
            grads = [p.grad for path, p in adamw.named_leaves(params)
                     if p.grad is not None and path not in fsdp]
            tp.all_reduce_(grads, dgroup, "data")
            for p in leaves:
                if p.grad is not None:
                    p.grad.div_(dp)
            names = sorted(metrics)
            vals = torch.stack([loss.float()] + [metrics[k].float()
                                                 for k in names])
            vals = tp.all_reduce(vals, dgroup, "metric") / dp
            loss = vals[0]
            metrics = {k: vals[i + 1] for i, k in enumerate(names)}
        return loss, metrics

    return grad_fn


def fsdp_paths(cfg, plan) -> frozenset:
    """Paths of the leaves ``plan`` holds as FSDP slices (none without
    ``plan.fsdp``)."""
    if not plan.fsdp:
        return frozenset()
    return frozenset(MX.fsdp_layout(cfg, plan.tp_size, plan.dp_size))


def make_train_step(cfg, ocfg: adamw.AdamWConfig, plan=None,
                    num_microbatches: int = 1, on_grads=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    state = {"params", "opt"} (``init_state``); ``batch["tokens"]`` (B, S)
    is split into ``num_microbatches`` sequential microbatches along B.
    ``metrics``: "loss" and "grad_norm" (0-d tensors on the device; no sync
    with the host), plus "ce" and "aux" when there is one microbatch, as in
    the reference.

    Under an explicit-TP plan ``state["params"]`` holds this rank's shard
    (``launch.mesh.shard_params``): after the backward the partial
    gradients of replicated leaves are summed over the group
    (``model.tp_sync_grads``, one all-reduce) and the global norm sums the
    shards' squares over it (one scalar all-reduce), so clipping and every
    update equal the single device's.  Under a data group see the module's
    docstring: the gradients are averaged over it before the norm, which
    then needs no sum over it, except of FSDP slices (one scalar
    all-reduce over the data group).  ``on_grads(params)``, when given, is
    called with the final gradients in ``.grad``, before the clip and the
    update (to read them: the update clips them in place)."""
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.TRAIN)
    plan.validate(cfg)
    grad_fn = make_grad_fn(cfg, plan, num_microbatches)
    group = plan.group if plan.use_explicit_tp else None
    fsdp = fsdp_paths(cfg, plan)
    dgroup = plan.data_group if fsdp else None

    def train_step(state, batch):
        params = state["params"]
        loss, metrics = grad_fn(params, batch)
        if on_grads is not None:
            on_grads(params)
        sharded = frozenset()
        if group is not None:
            sharded = MX.sharded_paths(params, cfg, plan.tp_size)
        leaves = _leaves(params)
        grads = adamw.map_tree(lambda p: p.grad, params)
        _, _, gnorm = adamw.adamw_update(params, grads, state["opt"], ocfg,
                                         group=group, sharded=sharded,
                                         data_group=dgroup, fsdp=fsdp)
        for p in leaves:
            p.grad = None
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def init_state(seed, cfg, ocfg: adamw.AdamWConfig, *, device=None,
               params=None):
    """{"params", "opt"}: fp32 master weights (``cfg.param_dtype``) drawn
    from ``seed`` on ``device`` (None: the card), or the given ``params``
    tree (e.g. ``interop.params_from_numpy(..., dtype=cfg.param_dtype)``),
    each leaf set to require gradients; and the AdamW state."""
    if params is None:
        params = M.init_params(cfg, seed=seed, device=device,
                               dtype=cfg.param_dtype)
    for p in _leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": adamw.init_opt_state(params, ocfg)}


def make_eval_step(cfg, plan=None):
    """Returns ``eval_step(params, batch) -> {"ce", "aux", "loss", "ppl"}``
    (0-d tensors), without gradients."""
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.EVAL)
    plan.validate(cfg)
    loss_fn = make_loss_fn(cfg, plan)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss, ppl=torch.exp(metrics["ce"]))
    return eval_step
