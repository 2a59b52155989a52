"""Rank-side code of the port's MoE tests (``test_torch_moe.py``,
``test_torch_moe_model.py``): each function runs in every rank spawned by
``repro_torch.core.tp.run_ranks`` and returns plain tensors and numbers.
It imports neither JAX nor the JAX package (the ranks never run JAX), so
it is a module of its own and not a test file."""
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models import model as M
from repro_torch.models import moe as MO
from repro_torch.optim import adamw as TO
from repro_torch.train import step as TT

import torch_tp_ranks as R

ARCH = "qwen3-moe-30b-a3b"
EP_PATHS = {"sharded": MO.moe_apply_sharded,
            "shard_slot": MO.moe_apply_shard_slot}


def ep_config(**kw):
    return get_config(ARCH).reduced().replace(**kw)


def _local_experts(np_params, rank, n):
    """This rank's slice of the experts and the replicated rest, each a
    leaf that requires gradients."""
    def t(a):
        return torch.from_numpy(a).clone().requires_grad_(True)

    E = np_params["wi"].shape[0]
    lo, hi = rank * E // n, (rank + 1) * E // n
    p = {"router": t(np_params["router"])}
    for k in ("wi", "wg", "wo"):
        p[k] = t(np_params[k][lo:hi])
    if "shared" in np_params:
        p["shared"] = {k: t(v) for k, v in np_params["shared"].items()}
    return p


def ep(group, cases, x, dp_case):
    """For each case {name: (path, config kwargs, numpy weights)}: this
    rank's token shard (along the sequence) of x (B, S, d) through the
    expert-parallel path -> {name: {"y", "aux", "grads" (of sum(y^2): the
    params and "x"), "forward" / "backward" collective counts}}; and under
    "dp" ``dp_aux(*dp_case)``'s results."""
    rank, n = group.rank(), group.size()
    out = {}
    for name, (path, kw, np_params) in cases.items():
        cfg = ep_config(**kw)
        p = _local_experts(np_params, rank, n)
        s = x.shape[1] // n
        x_loc = torch.from_numpy(x[:, rank * s:(rank + 1) * s]).clone()
        x_loc.requires_grad_(True)
        tp.reset_collectives()
        y, aux = EP_PATHS[path](p, cfg, x_loc, group)
        fwd = tp.collective_counts()
        tp.reset_collectives()
        (y ** 2).sum().backward()
        bwd = tp.collective_counts()
        grads = TO.map_tree(lambda q: q.grad.detach().clone(), p)
        grads["x"] = x_loc.grad.detach().clone()
        out[name] = {"y": y.detach(), "aux": float(aux), "grads": grads,
                     "forward": fwd, "backward": bwd}
    out["dp"] = dp_aux(*dp_case)
    return out


def dp_aux(np_params, toks):
    """tp 2 x dp 2 (``tp.split_groups``) over the reduced qwen3-moe at 4
    layers: each rank's loss on its data rank's rows of ``toks``, with the
    data group in the plan and without -> {"aux", "aux_local", "loss",
    "loss_local", "router_grad_equal"} (block 1's router gradient the same
    both ways: the data group's mean changes aux's value, not its
    gradient)."""
    from repro_torch.data.pipeline import shard_rows
    groups = tp.split_groups(2)
    cfg = R.tp_config("fal", arch=ARCH)
    plans = {"dp": ExecutionPlan.from_group(groups.tp, tp="explicit",
                                            data_group=groups.dp),
             "local": ExecutionPlan.from_group(groups.tp, tp="explicit")}
    rows = shard_rows({"tokens": torch.from_numpy(toks)},
                      plans["dp"].dp_rank, plans["dp"].dp_size)
    shard = R._shard(np_params, cfg, plans["dp"].tp_rank, 2)
    res = {}
    for name, plan in plans.items():
        for _, q in TO.named_leaves(shard):
            q.grad = None
        loss, m = M.loss_fn(shard, cfg, rows, plan)
        loss.backward()
        res[name] = (float(loss), float(m["aux"]),
                     shard["blocks"][0]["ffn"]["router"].grad.clone())
    return {"aux": res["dp"][1], "aux_local": res["local"][1],
            "loss": res["dp"][0], "loss_local": res["local"][0],
            "router_grad_equal": torch.equal(res["dp"][2], res["local"][2])}


def tp_parity(group, cases, toks, train_case):
    """For each case {name: (``tp_config`` kwargs, reference weights)}: the
    reduced qwen3-moe under explicit TP and TP + SP -> logits, loss,
    gradients after the sync, the forward's and the training pass's
    collective counts; and one train step (``train_case``: weights,
    tokens, AdamW kwargs) -> its metrics."""
    rank, size = group.rank(), group.size()
    toks = torch.from_numpy(toks)
    out = {}
    for name, (kw, np_params) in cases.items():
        cfg = R.tp_config(arch=ARCH, **kw)
        for sp in (False, True):
            plan = ExecutionPlan.from_group(group, tp="explicit", sp=sp)
            logits, loss, grads, fwd, train = R._forward_backward(
                R._shard(np_params, cfg, rank, size), cfg, plan, toks)
            out[(name, sp)] = {"logits": logits, "loss": loss,
                               "grads": grads, "forward": fwd,
                               "train": train}
    np_params, step_toks, ocfg_kw = train_case
    cfg = R.tp_config("fal", arch=ARCH)
    ocfg = TO.AdamWConfig(**ocfg_kw)
    plan = ExecutionPlan.from_group(group, tp="explicit")
    state = TT.init_state(0, cfg, ocfg,
                          params=R._shard(np_params, cfg, rank, size))
    _, m = TT.make_train_step(cfg, ocfg, plan)(
        state, {"tokens": torch.from_numpy(step_toks)})
    out["train"] = {k: float(v) for k, v in m.items()}
    return out
