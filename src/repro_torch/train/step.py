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
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import ExecutionPlan, Phase
from repro_torch.models import model as M
from repro_torch.optim import adamw


def make_loss_fn(cfg, plan=None):
    plan = ExecutionPlan.resolve(plan)

    def loss(params, batch):
        return M.loss_fn(params, cfg, batch, plan)
    return loss


def _leaves(params):
    return [t for _, t in adamw.named_leaves(params)]


def make_train_step(cfg, ocfg: adamw.AdamWConfig, plan=None,
                    num_microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    state = {"params", "opt"} (``init_state``); ``batch["tokens"]`` (B, S)
    is split into ``num_microbatches`` sequential microbatches along B.
    ``metrics``: "loss" and "grad_norm" (0-d tensors on the device; no sync
    with the host), plus "ce" and "aux" when there is one microbatch, as in
    the reference."""
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.TRAIN)
    plan.validate(cfg)
    loss_fn = make_loss_fn(cfg, plan)

    def train_step(state, batch):
        params = state["params"]
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
        grads = adamw.map_tree(lambda p: p.grad, params)
        _, _, gnorm = adamw.adamw_update(params, grads, state["opt"], ocfg)
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
