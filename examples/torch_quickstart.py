"""Quickstart of the PyTorch port: build a FAL model, run a forward pass,
train a few steps, and show the TP all-reduce halving.  Twin of
``examples/quickstart.py``.

The execution layout is a typed ``ExecutionPlan`` (``core/plan.py``): one
device, or explicit partial-sum TP over a process group, optionally with
sequence-parallel LN regions.  The TP demo runs ``--tp`` ranks as processes
(``core/tp.py`` ``run_ranks``) joined by gloo: on one card NCCL refuses two
ranks, so gloo stages their tensors through host memory.  The counts are
the ranks' own collective counters (``tp.collective_counts()``), the
port's counterpart of counting the HLO's collectives.

Run on the card:  PYTHONPATH=src python examples/torch_quickstart.py
On the CPU (the kernels' plain versions): add ``--device cpu``.
"""
import argparse
import os
import sys

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.train import trainer

#: the TP demo's block stack: 4 layers, 8 heads of 32 (the flash kernels'
#: narrowest head), d_ff 4 d
TP_LAYERS, TP_D, TP_FF, TP_HEADS = 4, 256, 1024, 8


def tp_rank(group, device, modes):
    """One rank of the TP demo: for each mode, the stack's forward under
    explicit TP and under sequence parallelism, each with the collectives
    counted from zero.  Returns {"counts": {(mode, sp):
    collective_counts()}, "launches": the rank's kernel launches}."""
    dev = torch.device(device)
    ops.reset_launches()
    x = torch.randn((2, 16, TP_D), generator=torch.Generator().manual_seed(1))
    out = {}
    for mode in modes:
        for sp in (False, True):
            init, fwd = tp.make_tp_forward(group, TP_LAYERS, TP_D, TP_FF,
                                           TP_HEADS, mode, sp=sp, device=dev)
            p = init(0)
            tp.reset_collectives()
            with torch.no_grad():
                fwd(p, x.to(dev))
            out[(mode, sp)] = tp.collective_counts()
    return {"counts": out, "launches": ops.launch_counts()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--tp", type=int, default=8,
                    help="ranks of the TP demo")
    args = ap.parse_args(argv)
    device = M.resolve_device(args.device)

    # ---- 1. a reduced llama3.2 with the paper's FAL connection -----------
    cfg = get_config("llama3.2-3b").reduced().replace(connection="fal")
    params = M.init_params(cfg, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 64),
                                     generator=gen).to(device)}
    plan = ExecutionPlan.single_device()      # phase=train, no group, no TP
    logits, aux, _ = M.forward(params, cfg, batch, plan)
    print(f"forward: logits {tuple(logits.shape)}, FAL connection = "
          f"{cfg.connection}")

    # ---- 2. train a few steps on the synthetic Markov corpus -------------
    state, hist = trainer.train(cfg, steps=args.steps, batch=8, seq_len=64,
                                plan=plan, log_every=10, device=device)

    # ---- 3. the paper's point: FAL halves per-block TP all-reduces -------
    # make_tp_forward builds REAL decoder blocks and runs them through the
    # explicit partial-sum stack (model.decoder_stack_tp) under
    # ExecutionPlan.from_group(group, tp="explicit"), one process a rank
    modes = ("preln", "fal")
    # the ranks import this file as a module: its directory goes on the
    # path they inherit
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    ranks = tp.run_ranks(f"{os.path.splitext(os.path.basename(__file__))[0]}"
                         f":tp_rank", args.tp, backend="gloo",
                         args=(device.type, modes), threads=1)
    counts = ranks[0]["counts"]
    print(f"rank 0's kernel launches: "
          f"{ {k: n for k, n in ranks[0]['launches'].items() if n} }")
    for mode in modes:
        n = tp.count(counts[(mode, False)], "all-reduce")
        print(f"{mode:7s}: forward all-reduces = {n} over {TP_LAYERS} "
              f"blocks (steady-state per block: "
              f"{2 if mode == 'preln' else 1})")

    # ---- 4. sequence-parallel LN regions (ExecutionPlan sp=True) ---------
    # same reduce-collective count, but the inter-block activations stay
    # sharded over the group: each all-reduce becomes a reduce-scatter at
    # 1/tp the bytes (block 0 keeps the one all-reduce that exports the
    # first-attention signal); each rank's plan.validate raises on a head /
    # tp divisibility the stack cannot take, before any forward
    for mode in modes:
        c = counts[(mode, True)]
        print(f"{mode:7s} sp: reduce-scatter bytes = "
              f"{tp.count(c, 'reduce-scatter', what='bytes')} (vs all-reduce "
              f"bytes {tp.count(c, 'all-reduce', what='bytes')} kept by "
              f"block 0), all-gather bytes = "
              f"{tp.count(c, 'all-gather', what='bytes')}")
    return {"logits_shape": tuple(logits.shape), "history": hist,
            "tp": {f"{m}{'_sp' if sp else ''}": c
                   for (m, sp), c in counts.items()},
            "rank_launches": ranks[0]["launches"]}


if __name__ == "__main__":
    main()
