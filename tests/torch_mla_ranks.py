"""Rank-side code of the port's MLA and VLM tensor-parallel tests
(``test_torch_mla_model.py``, ``test_torch_vlm.py``): each function runs
in every rank spawned by ``repro_torch.core.tp.run_ranks`` and returns
plain tensors and numbers.  It imports neither JAX nor the JAX package
(the ranks never run JAX), so it is a module of its own and not a test
file."""
import torch

from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models import model as M
from repro_torch.optim import adamw as TO

import torch_tp_ranks as R


def tp_parity(group, arch, cases, batch):
    """For each case {name: (``tp_config`` kwargs, reference weights)}: the
    reduced ``arch`` at 4 layers under explicit TP and TP + SP over
    ``batch`` (numpy arrays: tokens, and image_embeds for a VLM) ->
    {(name, sp): logits, loss, the loss's metrics, this rank's gradients
    after ``tp_sync_grads``, the no-grad forward's collective counts}."""
    rank, size = group.rank(), group.size()
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, (kw, np_params) in cases.items():
        cfg = R.tp_config(arch=arch, **kw)
        for sp in (False, True):
            plan = ExecutionPlan.from_group(group, tp="explicit", sp=sp)
            shard = R._shard(np_params, cfg, rank, size)
            tp.reset_collectives()
            with torch.no_grad():
                logits = M.forward(shard, cfg, batch, plan)[0]
            fwd = tp.collective_counts()
            loss, metrics = M.loss_fn(shard, cfg, batch, plan)
            loss.backward()
            M.tp_sync_grads(shard, cfg, plan)
            out[(name, sp)] = {
                "logits": logits, "loss": float(loss),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": TO.map_tree(lambda p: p.grad.detach().clone(),
                                     shard),
                "forward": fwd}
    return out
