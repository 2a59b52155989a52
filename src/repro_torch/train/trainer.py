"""The training loop: data -> train_step -> logging / eval.

Port of ``repro/train/trainer.py:25-81``.  Per-step metrics go through the
port's ``obs.metrics`` registry with the reference's names: every logged
scalar of the step (loss, grad_norm, ...) lands in a ``train_<k>`` gauge,
the step's wall time in the ``train_step_ms`` histogram, the step and token
counts in ``train_steps_total`` / ``train_tokens_total``, and the eval
perplexity in ``train_eval_ppl``.  The step's wall time ends at a device
synchronise, so on the card it includes the device's work.

Runs on the card unless ``device="cpu"``.  ``params`` starts training from
a given tree (fp32 masters, e.g. weights carried across from the reference)
instead of drawing them from ``seed``.  With ``ckpt_dir`` the state is saved
once after the last step (``train.checkpoint``, the reference's format, at
``step=steps``), as the reference does; there is no resume argument, as
there is none in the reference: resuming is ``checkpoint.restore`` into a
state of the same structure, then ``step.make_train_step``.

Under a distributed ``plan`` (``ExecutionPlan.from_group``: explicit TP,
a data group, or both) every rank runs ``train`` with the same arguments.
Under TP the weights (drawn from ``seed`` or given whole in ``params``)
are cut to this rank's shard (``launch.mesh.shard_params``) and the
returned state holds the shard.  Every rank draws the same GLOBAL batch of
``batch`` rows (``SyntheticMarkov(..., host_id=0, num_hosts=1)``, as the
reference's jitted trainer does) and trains on its data rank's rows
(``data.pipeline.shard_rows``), so a run of a seed over any tp x dp
layout trains on the batches a one-device run of that seed does;
``batch`` must divide by ``dp_size * num_microbatches``.  ``ckpt_dir``
writes the one-device format from the gathered state
(``checkpoint.save_distributed``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.plan import ExecutionPlan
from repro_torch.data.pipeline import SyntheticMarkov, shard_rows
from repro_torch.launch import mesh as MX
from repro_torch.models import model as M
from repro_torch.models.model import resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.optim import adamw, schedules
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import step as tstep

_SITE = "train/trainer.py"


def train(cfg, *, steps=200, batch=8, seq_len=128, lr=3e-4, seed=0,
          plan=None, num_microbatches=1, log_every=20, eval_every=0,
          ckpt_dir=None, data=None, schedule="cosine", callbacks=(),
          metrics=None, device=None, params=None):
    """Returns (state, history).  ``metrics``: a ``MetricsRegistry`` to
    record into (one is created per run when omitted)."""
    device = resolve_device(device)
    plan = ExecutionPlan.resolve(plan)
    dp = plan.dp_size
    if batch % (dp * num_microbatches):
        raise ValueError(
            f"batch {batch} does not split into {dp} data-parallel ranks x "
            f"{num_microbatches} microbatches")
    if plan.use_explicit_tp:
        if params is None:
            params = M.init_params(cfg, seed=seed, device=device,
                                   dtype=cfg.param_dtype)
        params = MX.shard_params(params, cfg, plan.tp_rank, plan.tp_size)
    reg = metrics if metrics is not None else MetricsRegistry()
    c_steps = reg.counter("train_steps_total", unit="steps", site=_SITE)
    c_tokens = reg.counter("train_tokens_total", unit="tokens", site=_SITE)
    h_step_ms = reg.histogram("train_step_ms", unit="ms", site=_SITE)
    sched = {"cosine": schedules.warmup_cosine,
             "onecycle": schedules.one_cycle,
             "wsd": schedules.wsd}[schedule](lr, steps)
    ocfg = adamw.AdamWConfig(lr=sched)
    state = tstep.init_state(seed, cfg, ocfg, device=device, params=params)
    step_fn = tstep.make_train_step(cfg, ocfg, plan, num_microbatches)
    eval_fn = tstep.make_eval_step(cfg, plan)
    if data is None:
        data = SyntheticMarkov(cfg.vocab, seq_len, batch, seed=seed)
    it = iter(data)
    history = []
    t0 = time.time()
    t_prev = time.perf_counter()
    for i in range(steps):
        glob = next(it)
        b = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in shard_rows(glob, plan.dp_rank, dp).items()}
        state, metrics_out = step_fn(state, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_now = time.perf_counter()
        c_steps.inc()
        c_tokens.inc(int(np.prod(np.shape(glob["tokens"]))))
        h_step_ms.record((t_now - t_prev) * 1e3)
        t_prev = t_now
        if (log_every and i % log_every == 0) or i == steps - 1:
            m = {k: float(v) for k, v in metrics_out.items()}
            for k, v in m.items():
                reg.gauge(f"train_{k}", site=_SITE).set(v)
            m.update(step=i, wall=time.time() - t0)
            history.append(m)
            if log_every:
                print(f"step {i:5d} loss {m['loss']:.4f} "
                      f"gnorm {m.get('grad_norm', 0):.2f} "
                      f"({m['wall']:.1f}s)", flush=True)
        if eval_every and i and i % eval_every == 0:
            # the whole global eval batch on every rank: one perplexity
            eb = {k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in data.batch_at(10**6 + i).items()}
            em = eval_fn(state["params"], eb)
            reg.gauge("train_eval_ppl", site=_SITE).set(float(em["ppl"]))
            print(f"  eval ppl {float(em['ppl']):.3f}", flush=True)
        for cb in callbacks:
            cb(i, state, metrics_out)
    if ckpt_dir:
        meta = {"arch": cfg.arch_id, "connection": cfg.connection}
        if plan.is_sharded or plan.data_group is not None:
            ckpt.save_distributed(ckpt_dir, state, cfg, plan, step=steps,
                                  meta=meta)
        else:
            ckpt.save(ckpt_dir, state, step=steps, meta=meta)
    return state, history
