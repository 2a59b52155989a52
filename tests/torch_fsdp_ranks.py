"""Rank-side code of the port's FSDP tests (``test_torch_fsdp.py``): each
function runs in every rank spawned by ``repro_torch.core.tp.run_ranks``
and returns plain tensors and numbers for the test process to compare.  It
imports neither JAX nor the JAX package (the ranks never run JAX), so it is
a module of its own and not a test file.

The reduced configs have no dim of 1024, the reference's floor: every
rank lowers ``launch.mesh.FSDP_MIN_DIM`` to the test's floor first, as the
test process lowers the reference's ``_FSDP_MIN_DIM``."""
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.core import tp
from repro_torch.core.plan import Phase
from repro_torch.data.pipeline import shard_rows
from repro_torch.launch import mesh as MX
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw as TO
from repro_torch.serve.decode import make_serve_step
from repro_torch.train import checkpoint as CK
from repro_torch.train import step as TT
from repro_torch.train import trainer

from torch_dp_ranks import _clone, _equal, dp_plan
from torch_tp_ranks import tp_config


def _slices(np_params, cfg, plan):
    """This rank's TP shard of the reference's weights, cut to its FSDP
    slices under ``plan.fsdp``, requiring gradients."""
    params = interop.params_from_numpy(np_params, cfg, "cpu",
                                       dtype="float32")
    if plan.group is not None:
        params = MX.shard_params(params, cfg, plan.tp_rank, plan.tp_size)
    if plan.fsdp:
        params = MX.shard_fsdp(params, cfg, plan.dp_rank, plan.dp_size,
                               plan.tp_size)
    for _, p in TO.named_leaves(params):
        p.requires_grad_(True)
    return params


def _rows(toks, plan):
    return torch.from_numpy(shard_rows({"tokens": toks}, plan.dp_rank,
                                       plan.dp_size)["tokens"])


def _batch(toks, extra, i, plan):
    """Step ``i``'s batch of this rank's rows: the tokens and each
    ``extra`` input (whisper's frames) of the step."""
    glob = {"tokens": toks[i], **{k: v[i] for k, v in (extra or {}).items()}}
    return {k: torch.from_numpy(v) for k, v in
            shard_rows(glob, plan.dp_rank, plan.dp_size).items()}


def _train(cfg, plan, ocfg, np_params, toks, nm, extra=None):
    """``len(toks)`` train steps of this rank's rows under ``plan`` (FSDP,
    or without it plain data parallelism) -> state, metrics and each
    step's collective counts."""
    state = TT.init_state(0, cfg, ocfg, params=_slices(np_params, cfg, plan))
    step = TT.make_train_step(cfg, ocfg, plan, nm)
    metrics, counts = [], []
    for i in range(len(toks)):
        tp.reset_collectives()
        state, m = step(state, _batch(toks, extra, i, plan))
        counts.append(tp.collective_counts())
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, counts


def _pad_zero(state, cfg, plan):
    """Whether every slice's padding rows (past the leaf's end) are zero in
    the params and both moments; and how many leaves have padding."""
    layout = MX.fsdp_layout(cfg, plan.tp_size, plan.dp_size)
    ok, padded = True, 0
    for tree in (state["params"], state["opt"]["m"], state["opt"]["v"]):
        for path, t in TO.named_leaves(tree):
            if path not in layout:
                continue
            dim, n = layout[path]
            k = t.shape[dim]
            valid = max(0, min(k, n - plan.dp_rank * k))
            if valid < k:
                padded += 1
                ok &= bool((t.detach().narrow(dim, valid, k - valid)
                            == 0).all())
    return ok, padded


def fsdp_world(groups, cases, toks, ocfg_kw, floor, ckpt_dir, serve,
               trainer_kw, ep, with_dp=()):
    """Every case's FSDP train steps on this rank of a tp x dp world (the
    cases named in ``with_dp`` also without FSDP: plain data parallelism,
    under key ``"dp"``); then, where given, the checkpoint round trip
    (``ckpt_dir``), prefill and decode ticks (``serve``: (config kwargs,
    weights, global batch)), ``trainer.train`` (``trainer_kw``) and the
    expert-parallel MoE FFN with its experts sliced over the data group
    (``ep``)."""
    MX.FSDP_MIN_DIM = floor
    plan = dp_plan(groups, fsdp=True)
    out = {"rank": dist.get_rank(), "tp_rank": plan.tp_rank,
           "dp_rank": plan.dp_rank, "tp_size": plan.tp_size,
           "dp_size": plan.dp_size}
    for name, kw, np_params, runs, extra in cases:
        for nm, remat in runs:
            cfg = tp_config(remat=remat, **kw)
            ocfg = TO.AdamWConfig(**ocfg_kw)
            state, metrics, counts = _train(cfg, plan, ocfg, np_params,
                                            toks[:-1], nm, extra)
            res = {"metrics": metrics, "counts": counts,
                   "params": _clone(state["params"]),
                   "pad": _pad_zero(state, cfg, plan)}
            if name in with_dp:
                dp_state, _, _ = _train(cfg, dp_plan(groups), ocfg,
                                        np_params, toks[:-1], nm, extra)
                res["dp"] = _clone(dp_state["params"])
                del dp_state
            out[(name, nm, remat)] = res
            if ckpt_dir is not None and name == "llama" and (nm, remat) \
                    == (1, False):
                out["ckpt"] = _checkpoint(state, cfg, plan, ocfg, ckpt_dir,
                                          toks[-1])
    if serve is not None:
        out["serve"] = _serve(plan, *serve)
    if trainer_kw is not None:
        _, hist = trainer.train(tp_config("fal"), plan=plan, device="cpu",
                                log_every=1, **trainer_kw)
        out["trainer"] = [(h["loss"], h["grad_norm"]) for h in hist]
    if ep is not None:
        out["ep"] = _ep_moe(groups, *ep)
    return out


def _checkpoint(state, cfg, plan, ocfg, ckpt_dir, toks):
    """Save under the FSDP plan, restore into this rank's slices, and one
    more step from the restored state and from the state itself."""
    before = _clone(state)
    tp.reset_collectives()
    CK.save_distributed(ckpt_dir, state, cfg, plan, step=3,
                        meta={"arch": cfg.arch_id})
    counts = tp.collective_counts()
    restored = CK.restore_sharded(ckpt_dir, state, cfg, plan)
    res = {"state": before, "counts": counts,
           "restored_equal": _equal(restored, before),
           "requires_grad": all(p.requires_grad for _, p in
                                TO.named_leaves(restored["params"]))}
    step = TT.make_train_step(cfg, ocfg, plan)
    batch = {"tokens": _rows(toks, plan)}
    a, ma = step(restored, batch)
    b, mb = step(state, batch)
    res["step_equal"] = _equal(a, b) and float(ma["loss"]) == float(
        mb["loss"])
    return res


def _serve(plan, kw, np_params, toks, ticks):
    """Prefill logits and ``ticks`` contiguous decode ticks of this rank's
    rows under the FSDP serving plans, and on one device from the whole
    weights -> the logits, greedy tokens and each tick's counts."""
    cfg = tp_config(**kw)
    sliced = _slices(np_params, cfg, plan)
    full = interop.params_from_numpy(np_params, cfg, "cpu", dtype="float32")
    rows = _rows(toks, plan)
    out = {}
    with torch.no_grad():
        tp.reset_collectives()
        out["prefill"] = M.forward(sliced, cfg, {"tokens": rows},
                                   plan.with_phase(Phase.PREFILL))[0]
        out["prefill_counts"] = tp.collective_counts()
        out["prefill_one"] = M.forward(full, cfg, {"tokens": rows},
                                       Phase.PREFILL)[0]
    B, S = rows.shape
    for key, params, p in (("decode", sliced, plan),
                           ("decode_one", full, None)):
        cache = M.init_cache(cfg, B, S, "float32", device="cpu",
                             tp_size=plan.tp_size if p is not None else 1)
        step = make_serve_step(cfg, p)
        logits, nxt, counts = [], [], []
        for t in range(ticks):
            tp.reset_collectives()
            n, lg, cache = step(params, cache, rows[:, t:t + 1],
                                torch.full((B,), t, dtype=torch.int32))
            counts.append(tp.collective_counts())
            logits.append(lg)
            nxt.append(n)
        out[key] = {"logits": torch.cat(logits, 1),
                    "next": torch.stack(nxt, 1), "counts": counts}
    return out


def _ep_moe(groups, kw, np_ffn, x):
    """The expert-parallel MoE FFN (``moe_apply_sharded`` over the TP
    group as the expert group) with its leaves sliced over the data group,
    against the same call on whole leaves: outputs, and the slices'
    gradients against the whole leaves' summed over the data group and
    sliced.  ``np_ffn``: the whole FFN's numpy leaves; ``x``: (dp, ep, b,
    s, d) token shards."""
    cfg = tp_config(**kw)
    ep, dgroup = groups.tp, groups.dp
    E_loc = cfg.n_experts // ep.size()
    lo = ep.rank() * E_loc
    whole = {k: torch.from_numpy(v[lo:lo + E_loc] if k != "router" else v)
             for k, v in np_ffn.items()}
    i = cfg.first_dense_layers
    prefix = ("block0", "ffn") if i == 0 else ("blocks", i - 1, "ffn")
    cuts = MX.fsdp_cuts(cfg, 1, dgroup.size(), prefix)
    sliced = {k: MX.fsdp_slice(v, cuts[(k,)][0], dgroup.rank(),
                               dgroup.size()) if (k,) in cuts else v.clone()
              for k, v in whole.items()}
    xs = torch.from_numpy(x[dgroup.rank(), ep.rank()])
    res = {"sliced": sorted(k for (k,) in cuts)}
    outs, grads = {}, {}
    for name, p, dg in (("whole", whole, None), ("fsdp", sliced, dgroup)):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        tp.reset_collectives()
        y, aux = MOE.moe_apply_sharded(p, cfg, xs, ep, data_group=dg)
        (y.square().sum() + aux).backward()
        res[f"{name}_counts"] = tp.collective_counts()
        outs[name] = y.detach()
        grads[name] = {k: v.grad for k, v in p.items()}
    res["out_err"] = float((outs["fsdp"] - outs["whole"]).abs().max())
    err = 0.0
    for k, g in grads["whole"].items():
        if (k,) not in cuts:
            continue
        dim = cuts[(k,)][0]
        g = tp.all_reduce(g, dgroup, "step")
        want = MX.fsdp_slice(g, dim, dgroup.rank(), dgroup.size())
        err = max(err, float((grads["fsdp"][k] - want).abs().max()))
    res["grad_err"] = err
    return res
