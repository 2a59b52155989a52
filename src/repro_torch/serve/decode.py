"""Serving over the contiguous KV cache: the one-token greedy step, prompt
prefill by decode steps, and a slot batcher.

Port of ``repro/serve/decode.py``: ``make_serve_step`` (``:22``),
``make_prefill_then_decode`` (``:46``), ``Request`` (``:69``) and
``ContinuousBatcher`` (``:78``), over ``models.model.init_cache`` /
``decode_step``.  The steps run eagerly (the reference jits them).  Every
tick is one (B, 1) model call and every lane advances one token, so a
prompt prefills one call a token; the paged engine
(``serve.scheduler.PagedEngine``) packs prompt chunks into one call instead,
and its ``stats()`` reports the same ``dispatches_per_tick`` / occupancy
fields, so the two compare directly.

Every family's contiguous cache serves here: mamba2 and zamba2 through the
batcher; whisper by filling ``cache["enc_out"]`` with
``models.model.whisper_encode``'s output and then stepping, as the
reference's tests do (``Request`` carries no frames, as the reference's
does not).  One repair of the reference: its batcher never resets a slot
when a new request takes it, which is harmless for KV rows (rewritten
before they are read) but not for a recurrent state, which would carry the
last request's SSM state and conv window into the next.  The port's
batcher zeroes the slot's recurrent leaves (``recurrent_leaves``) when a
request takes it; KV leaves are left as the reference leaves them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.plan import ExecutionPlan, Phase
from repro_torch.models import model as M
from repro_torch.obs.metrics import MetricsRegistry

_SITE = "serve/decode.py"


def recurrent_leaves(cfg, cache):
    """(tensor, slot axis) of each recurrent leaf of a contiguous cache:
    mamba's stacked ``state`` / ``conv`` (L, B, ...), zamba's ``mamba``
    (n_groups, attn_every, B, ...) and ``mamba_tail`` (trailing, B, ...).
    The decoder and whisper caches hold none."""
    if cfg.family == "ssm":
        return [(t, 1) for t in cache["blocks"].values()]
    if cfg.family == "hybrid":
        return ([(t, 2) for t in cache["mamba"].values()]
                + [(t, 1) for t in cache.get("mamba_tail", {}).values()])
    return []


def _device_of(cache):
    while isinstance(cache, dict):
        cache = next(iter(cache.values()))
    return cache.device


def make_serve_step(cfg, plan=None, dual_branch=False):
    """serve_step(params, cache, tokens (B, 1), pos (B,)) -> (next_token
    (B,) int32, logits (B, 1, V), cache updated in place): greedy argmax.

    ``plan``'s phase is pinned to decode; an explicit-TP plan runs the
    sharded blocks (``models.model.serving_plan``; ``params`` and ``cache``
    this rank's).  ``dual_branch=True`` (or a plan with ``dual_branch``
    set) runs the blocks after block 0 as MHA || MLP,
    valid only for connections whose MLP input does not read the block's
    own attention (``plan.validate`` rejects the rest)."""
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.DECODE)
    if dual_branch:
        plan = plan.with_dual_branch()
    plan.validate(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        batch = {"tokens": tokens, "pos": pos}
        logits, cache = M.decode_step(params, cfg, batch, cache, plan)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step


def make_prefill_then_decode(cfg, plan=None):
    """generate(params, prompts (B, P) int array, max_new, cache) ->
    (tokens (B, max_new) int32 numpy, cache): the prompt teacher-forced
    into the cache one decode step a token, then greedy decode.  Runs on
    the cache's device."""
    serve_step = make_serve_step(cfg, plan)

    def generate(params, prompts: np.ndarray, max_new: int, cache):
        B, P = prompts.shape
        device = _device_of(cache)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                               device=device)
        out = []
        nxt = toks[:, 0]
        for t in range(P + max_new - 1):
            cur = toks[:, t:t + 1] if t < P else nxt[:, None]
            pos = torch.full((B,), t, dtype=torch.int32, device=device)
            nxt, _, cache = serve_step(params, cache, cur, pos)
            if t >= P - 1:
                out.append(nxt.cpu().numpy())
        return np.stack(out, 1), cache

    return generate


# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,)
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    pos: int = 0
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching over the contiguous cache: B fixed
    slots, a finished request's slot goes to the next queued one.  Each
    slot's position is its own, so one tick is one (B, 1) ``decode_step``
    with a per-lane ``pos``; an empty slot decodes token 0 at position 0
    (its KV rows are rewritten before any request reads them).  A request
    taking a slot starts from zeroed recurrent leaves
    (``recurrent_leaves``: mamba / zamba), as it would from a fresh
    cache.

    ``device``: where the cache lives and the params must be; None means
    ``cuda`` and raises without one.  ``plan``: None or an explicit-TP
    plan (``ExecutionPlan.from_group(group, tp="explicit")``) with
    ``params`` this rank's shard: one batcher a rank, fed the same
    requests, in lockstep; its cache holds this rank's KV heads and the
    greedy ids are the same on every rank.  ``metrics``: a ``MetricsRegistry``
    (one per batcher when omitted) holding ``batcher_ticks_total``,
    ``batcher_dispatches_total`` and ``batcher_occupancy``."""

    def __init__(self, cfg, params, batch_slots: int, max_seq: int,
                 cache_dtype="float32", plan=None, dual_branch=False,
                 metrics: Optional[MetricsRegistry] = None, device=None):
        self.cfg, self.params = cfg, params
        self.device = M.resolve_device(device)
        self.plan = ExecutionPlan.resolve(plan).with_phase(Phase.DECODE)
        if dual_branch:
            self.plan = self.plan.with_dual_branch()
        self.B = batch_slots
        self.max_seq = max_seq
        self.cache = M.init_cache(cfg, batch_slots, max_seq, cache_dtype,
                                  device=self.device,
                                  tp_size=self.plan.tp_size)
        self.serve_step = make_serve_step(cfg, self.plan)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_ticks = self.metrics.counter(
            "batcher_ticks_total", unit="ticks", site=_SITE)
        self._c_dispatches = self.metrics.counter(
            "batcher_dispatches_total", unit="calls", site=_SITE)
        self._h_occ = self.metrics.histogram(
            "batcher_occupancy", unit="ratio", site=_SITE)

    def submit(self, req: Request):
        self.queue.append(req)

    def _fill_slots(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.pop(0)
                for t, axis in recurrent_leaves(self.cfg, self.cache):
                    t.select(axis, i).zero_()

    def step(self):
        """One tick: feed each active slot its next token; returns the
        requests that finished."""
        self._fill_slots()
        self._c_ticks.inc()
        self._c_dispatches.inc()
        self._h_occ.record(sum(r is not None for r in self.slots) / self.B)
        toks = np.zeros((self.B, 1), np.int32)
        pos = np.zeros((self.B,), np.int32)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            if r.pos < len(r.prompt):
                toks[i, 0] = r.prompt[r.pos]
            else:
                toks[i, 0] = r.generated[-1]
            pos[i] = r.pos
        nxt, _, self.cache = self.serve_step(
            self.params, self.cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device))
        nxt = nxt.cpu().numpy()
        finished = []
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            r.pos += 1
            if r.pos >= len(r.prompt):
                r.generated.append(int(nxt[i]))
            if len(r.generated) >= r.max_new or r.pos >= self.max_seq - 1:
                r.done = True
                finished.append(r)
                self.slots[i] = None
        return finished

    def run(self):
        done = []
        while any(s is not None for s in self.slots) or self.queue:
            done += self.step()
        return done

    def reset_stats(self):
        self.metrics.reset()

    @property
    def ticks(self) -> int:
        return self._c_ticks.value

    @property
    def dispatches(self) -> int:
        return self._c_dispatches.value

    def stats(self) -> dict:
        return {
            "ticks": self.ticks,
            "dispatches": self.dispatches,
            "dispatches_per_tick": self.dispatches / max(self.ticks, 1),
            "mean_occupancy": self._h_occ.mean,
            "metrics": self.metrics.to_dict(),
        }
