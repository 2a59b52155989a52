"""Rank-side code of ``test_torch_seq_decode.py``: every function runs in
each rank spawned by ``repro_torch.core.tp.run_ranks`` and decodes over
its slice of a decode cache in the reference's layout
(``launch/mesh.py::cache_specs``), the KV sequence cut over the data
group, the model group or both, and returns plain tensors, token streams
and collective counts for the test process to compare with the
reference's one device.  It imports neither JAX nor the JAX package (the
ranks never run JAX), so it is a module of its own and not a test file."""
import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan
from repro_torch.launch import mesh as MX
from repro_torch.models import model as M
from repro_torch.serve import decode as D

from torch_tp_ranks import tp_config


def roles(group, role):
    """(tp group, data group) of a rank: a ``Groups`` as given, or, with one
    world group, the world in the ``role`` a case names ("model" or
    "data")."""
    if isinstance(group, tp.Groups):
        return group.tp, group.dp
    return (group, None) if role == "model" else (None, group)


def _sizes(tp_g, dp_g):
    return ((tp_g.size() if tp_g else 1), (tp_g.rank() if tp_g else 0),
            (dp_g.size() if dp_g else 1), (dp_g.rank() if dp_g else 0))


def _setup(group, case):
    """(cfg, this rank's params (its TP shard), its decode plan with the
    reference's cache layout at the case's global batch, its sizes and
    ranks).  The plan carries the data group only where the layout cuts
    the sequence over it: a batch that divides the data ranks gives each
    its own rows, a replica of its own."""
    cfg = tp_config(**case["kw"])
    tp_g, dp_g = roles(group, case["role"])
    tsize, trank, dsize, drank = _sizes(tp_g, dp_g)
    params = interop.params_from_numpy(case["weights"], cfg, "cpu",
                                       dtype="float32")
    if tp_g is not None:
        params = MX.shard_params(params, cfg, trank, tsize)
    cut = "data" in MX.seq_axes(cfg, tsize, dsize, case["B"])
    plan = ExecutionPlan.from_group(
        tp_g, tp="explicit" if tp_g is not None else "none",
        data_group=dp_g if cut else None).with_cache_layout(cfg, case["B"])
    return cfg, params, plan, (tsize, trank, dsize, drank)


def decode(group, cases):
    """Each case: its ranks' greedy ticks from ``tok0`` at the positions of
    ``ticks`` (T, B) over this rank's slice of the case's whole cache ->
    {name: {"logits" (T, rows, V), "tokens" (T, rows), "rows" (lo, hi),
    "positions" (lo, hi), "seq_axes", "counts" (a tick's collectives),
    "cache_bytes"}}."""
    out = {}
    for name, case in cases.items():
        cfg, params, plan, (ts, tr, ds, dr) = _setup(group, case)
        B, S = case["B"], case["S"]
        cache = MX.slice_cache(interop.cache_from_numpy(case["cache"], "cpu"),
                               cfg, ts, ds, B, tr, dr)
        part = MX.rank_slice(cfg, ts, ds, B, S, tr, dr)
        lo, hi = part["rows"]
        step = D.make_serve_step(cfg, plan)
        tok = torch.from_numpy(case["tok0"][lo:hi])
        logits, tokens, counts = [], [], []
        for pos in case["ticks"]:
            tp.reset_collectives()
            tok, lg, cache = step(params, cache, tok[:, None],
                                  torch.from_numpy(pos[lo:hi]))
            counts.append(tp.collective_counts())
            logits.append(lg[:, 0])
            tokens.append(tok)
        out[name] = {"logits": torch.stack(logits),
                     "tokens": torch.stack(tokens), "counts": counts,
                     "rows": part["rows"], "positions": part["positions"],
                     "seq_axes": plan.seq_axes,
                     "cache_bytes": sum(t.numel() * t.element_size()
                                        for t in _leaves(cache))}
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def batcher(group, case):
    """The ``ContinuousBatcher`` over this rank's plan (the same requests
    on every rank) -> ({rid: generated}, its plan's ``seq_axes``)."""
    cfg, params, plan, _ = _setup(group, case)
    cb = D.ContinuousBatcher(cfg, params, case["B"], case["S"], plan=plan,
                             device="cpu")
    for rid, prompt, max_new in case["reqs"]:
        cb.submit(D.Request(rid=rid, prompt=prompt, max_new=max_new))
    return {r.rid: r.generated for r in cb.run()}, cb.plan.seq_axes


def generate(group, case):
    """``make_prefill_then_decode`` over this rank's slice of a fresh
    cache -> the greedy tokens (B, max_new)."""
    cfg, params, plan, (ts, _, ds, _) = _setup(group, case)
    B, S = case["B"], case["S"]
    cache = M.init_cache(cfg, B, S, "float32", device="cpu", tp_size=ts,
                         dp_size=ds)
    toks, _ = D.make_prefill_then_decode(cfg, plan)(
        params, case["prompts"], case["max_new"], cache)
    return np.asarray(toks)


def run(group, cases, batchers, gens):
    """Every decode case, batcher and generation of one spawn."""
    with torch.no_grad():
        return {"decode": decode(group, cases),
                "batcher": {k: batcher(group, c) for k, c in
                            batchers.items()},
                "generate": {k: generate(group, c) for k, c in
                             gens.items()}}
