"""Continuous-batching scheduler over the paged KV cache, on torch.

Port of ``repro/serve/scheduler.py`` without speculative decoding and
seeded sampling: admission control ('prompt': prompt + 1 token; 'full':
prompt + max_new, no preemption), TOKEN-PACKED ticks (one model call per
tick over a flat ``(token_budget,)`` buffer where token t belongs to lane
``tok_slot[t]`` at position ``tok_pos[t]``; decode lanes are packed first,
prefill lanes share the rest round-robin), greedy selection, preemption
of the youngest other request under page pressure, and rejection of
requests that can never fit.
The engine's ``MetricsRegistry`` records TTFT, inter-token latency, queue
wait, occupancy, page utilisation and preemptions; ``stats()`` summarises
them.

Dual-branch decode (``EngineConfig.dual_branch``) runs each block after
block 0 as the MHA || MLP block (fal / parallel / ablation2 only).  On the
packed tick it launches no kernel of its own: the two branches run the
sequential path's ops, one after the other on one stream, so its token
streams equal the non-dual engine's.

Quantized KV pages (``EngineConfig.kv_dtype`` "int8" / "fp8") store narrow
pages with per-row fp32 scale pools; the ticks run the kernels' scale
variants.  The radix prefix cache (``EngineConfig.prefix_cache``,
``serve/prefix_cache.py``) matches each admitted prompt's longest cached
page-aligned prefix, maps its pages into the block table, prefills only the
rest, seeds the FAL ``a1_sig`` on a full-prompt hit, copies a shared page
before a lane writes into it (copy-on-write through the ``page_copy``
kernel) and parks every finished request's prefix.  Self-speculative
decoding and seeded sampling come in later slices of the port and raise
``NotImplementedError`` here.

The engine runs on the card unless the caller passes ``device="cpu"``.
``engine_dispatch_ms`` times one model call from its start to the moment
its sampled ids are on the host, so it includes the device's work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.plan import ExecutionPlan, Phase
from repro_torch.models import model as M
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve import sampling as SP
from repro_torch.serve.paged_cache import BlockTable, PageAllocator, pages_needed
from repro_torch.serve.prefix_cache import PrefixCache

_SITE = "serve/scheduler.py"


# --------------------------------------------------------------------------- #
# the engine's one model call per tick
# --------------------------------------------------------------------------- #
def make_packed_step(cfg, plan=None):
    """The packed tick: (params, cache, tokens (T,), tok_slot (T,),
    tok_pos (T,), block_tables (S, Tb), seg_last (S,)) -> (seg_logits
    (S, V), next_tokens (S,) int32, cache).

    Runs the blocks to hidden states, gathers each segment's last token
    (``seg_last``, -1 for lanes sitting the tick out) and applies the LM
    head to the (S, 1, D) gather only.  Lanes sitting out get a zeroed row
    before the head and the -1 sentinel instead of a sampled id.  The cache
    is updated in place."""
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.PAGED)
    plan.validate(cfg)

    @torch.no_grad()
    def step(params, cache, tokens, tok_slot, tok_pos, block_tables,
             seg_last):
        batch = {"tokens": tokens, "tok_slot": tok_slot, "tok_pos": tok_pos,
                 "block_tables": block_tables, "seg_last": seg_last}
        hidden, cache = M.paged_decode_step(params, cfg, batch, cache, plan,
                                            want="hidden")
        active = seg_last >= 0
        h_seg = hidden[0, seg_last.clamp(min=0).long()]           # (S, D)
        h_seg = torch.where(active[:, None], h_seg,
                            torch.zeros_like(h_seg))
        logits = M.lm_head(params, cfg, h_seg[:, None])[:, 0]     # (S, V)
        nxt = SP.greedy(logits)
        nxt = torch.where(active, nxt, torch.full_like(nxt, -1))
        return logits, nxt, cache

    return step


@dataclasses.dataclass(frozen=True)
class PackedTick:
    """One tick's flat token plan (host-side numpy, from ``pack_tokens``).
    ``tokens[t]`` is fed to lane ``tok_slot[t]`` at position ``tok_pos[t]``;
    the padding tail carries tok_slot == 0 and tok_pos == -1.
    ``seg_last[i]`` is the flat index of slot i's last token (-1 when the
    slot sat the tick out) and ``n_taken[i]`` how many tokens slot i
    advances."""
    tokens: np.ndarray                 # (T,) int32
    tok_slot: np.ndarray               # (T,) int32
    tok_pos: np.ndarray                # (T,) int32
    seg_last: np.ndarray               # (S,) int32
    n_taken: np.ndarray                # (S,) int32
    n_live: int


def pack_tokens(token_lists, positions, decode_flags, budget,
                prefill_cap=0, rotate=0) -> PackedTick:
    """Pure host-side token packer (``scheduler.py:272``): per-slot lists of
    pending context tokens at per-slot ``positions`` -> a ``PackedTick``
    over a flat ``(budget,)`` buffer.  Decode lanes are packed first and
    take their whole list; prefill lanes split the rest (capped at
    ``prefill_cap`` when non-zero) in round-robin order starting at slot
    ``rotate % slots``: one token each, then greedily.  Segments are laid
    out in slot order, decode lanes first."""
    S = len(token_lists)
    take = np.zeros((S,), np.int32)
    decode_ids = [i for i in range(S)
                  if len(token_lists[i]) and decode_flags[i]]
    prefill_ids = [i for i in range(S)
                   if len(token_lists[i]) and not decode_flags[i]]
    for i in decode_ids:
        take[i] = len(token_lists[i])
    left = budget - int(take.sum())
    if left < 0:
        raise ValueError("token budget below live decode lanes")
    if prefill_ids:
        start = rotate % S
        prefill_ids = ([i for i in prefill_ids if i >= start]
                       + [i for i in prefill_ids if i < start])
    pleft = min(left, prefill_cap) if prefill_cap else left
    for i in prefill_ids:                       # round 1: liveness
        if pleft <= 0:
            break
        take[i] = 1
        pleft -= 1
    for i in prefill_ids:                       # round 2: greedy fill
        if pleft <= 0:
            break
        extra = min(len(token_lists[i]) - int(take[i]), pleft)
        take[i] += extra
        pleft -= extra
    tokens = np.zeros((budget,), np.int32)
    tok_slot = np.zeros((budget,), np.int32)
    tok_pos = np.full((budget,), -1, np.int32)
    seg_last = np.full((S,), -1, np.int32)
    off = 0
    for i in decode_ids + sorted(prefill_ids):
        n = int(take[i])
        if n == 0:
            continue
        tokens[off:off + n] = token_lists[i][:n]
        tok_slot[off:off + n] = i
        tok_pos[off:off + n] = positions[i] + np.arange(n)
        off += n
        seg_last[i] = off - 1
    return PackedTick(tokens, tok_slot, tok_pos, seg_last, take, off)


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                 # (P,) int token ids
    max_new: int
    sampling: SP.SamplingParams = SP.SamplingParams()
    generated: list = dataclasses.field(default_factory=list)
    pos: int = 0                       # tokens of context written to cache
    done: bool = False
    truncated: bool = False            # hit the context cap / rejected
    preemptions: int = 0
    arrival: int = -1                  # submit order (preemption priority)
    submit_tick: int = -1
    finish_tick: int = -1
    submit_time: float = 0.0           # time.perf_counter seconds
    queued_tick: int = -1              # last (re-)queue tick, for queue wait
    last_token_time: float = 0.0
    decoding: bool = False             # per-residency phase (reset on preempt)
    # prefix-cache plumbing (EngineConfig.prefix_cache)
    pin_prefix: bool = False           # park this prefix pinned (no eviction)
    prefix_hit_tokens: int = 0         # cached tokens mapped at last admission
    # block 1's first-attention signal at position len(prompt)-1, captured
    # (a cloned a1_sig row, on the engine's device) the tick the first token
    # is sampled; cached with the prefix so a full-prompt hit seeds
    # cache["a1_sig"] instead of re-running block 0
    prefix_sig: Optional[torch.Tensor] = None

    def known(self) -> list:
        """Context to teacher-force: prompt + everything sampled so far."""
        return list(self.prompt) + self.generated


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Paged-engine knobs.  ``spec_tokens`` belongs to a later slice of the
    port and must keep its default here."""
    page_size: int = 16
    num_pages: int = 64                # pool size incl. scratch page 0
    slots: int = 4                     # concurrent batch lanes
    prefill_chunk: int = 16            # max prefill tokens per lane per tick
    # flat tokens per packed call; 0 = auto (slots + prefill_chunk - 1)
    token_budget: int = 0
    # cap on total prefill tokens per tick (0 = uncapped)
    max_prefill_tokens: int = 0
    max_seq: int = 256                 # per-request context cap
    admission: str = "prompt"          # 'prompt' | 'full'
    cache_dtype: str = "float32"
    # KV page storage ("" | "bf16" | "int8" | "fp8"): "" keeps cache_dtype
    # pools; int8 / fp8 store narrow pages plus per-row fp32 scale pools
    kv_dtype: str = ""
    dual_branch: bool = False
    # radix prefix cache over page-aligned finished prefixes;
    # max_cached_prefix_pages caps the tree's own pages (0 = the pool)
    prefix_cache: bool = False
    max_cached_prefix_pages: int = 0
    spec_tokens: int = 0


_LATER = {"spec_tokens": "speculative-decode"}


class PagedEngine:
    """Slot-based continuous batching over paged KV (dense decoder).

    ``device``: where the model and cache live; None means ``cuda`` and
    raises without one.  ``metrics``: a ``MetricsRegistry`` (one per engine
    when omitted).  ``tracer``: a ``Tracer``; the default records nothing."""

    def __init__(self, cfg, params, engine_cfg: EngineConfig = EngineConfig(),
                 plan=None, metrics: Optional[MetricsRegistry] = None,
                 tracer=None, device=None):
        M.check_supported(cfg)
        for name, what in _LATER.items():
            if getattr(engine_cfg, name):
                raise NotImplementedError(
                    f"EngineConfig.{name}: {what} comes in a later slice of "
                    f"the PyTorch port")
        if engine_cfg.admission not in ("prompt", "full"):
            raise ValueError(f"admission must be 'prompt' or 'full', got "
                             f"{engine_cfg.admission!r}")
        self.device = M.resolve_device(device)
        self.cfg, self.params, self.ecfg = cfg, params, engine_cfg
        self.budget = engine_cfg.token_budget or (
            engine_cfg.slots + engine_cfg.prefill_chunk - 1)
        if self.budget < engine_cfg.slots:
            raise ValueError(
                f"token_budget={self.budget} cannot keep all "
                f"{engine_cfg.slots} slots live (need >= slots * "
                f"1 packed rows per decode lane)")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.plan = ExecutionPlan.resolve(plan).with_phase(Phase.PAGED)
        if engine_cfg.dual_branch:
            self.plan = self.plan.with_dual_branch()
        self.plan.validate(cfg)
        self.max_blocks = pages_needed(engine_cfg.max_seq,
                                       engine_cfg.page_size)
        self.cache = M.init_paged_cache(
            cfg, engine_cfg.num_pages, engine_cfg.page_size,
            engine_cfg.slots, engine_cfg.cache_dtype,
            kv_dtype=engine_cfg.kv_dtype, device=self.device)
        self.step_fn = make_packed_step(cfg, self.plan)
        # device bytes per page across every layer's pools, scale pools
        # included, a1_sig excluded
        page_bytes = sum(t.numel() * t.element_size() // engine_cfg.num_pages
                         for part in ("block0", "blocks")
                         for t in self.cache[part].values())
        self.allocator = PageAllocator(engine_cfg.num_pages,
                                       engine_cfg.page_size,
                                       metrics=self.metrics,
                                       page_bytes=page_bytes)
        self.tables = [BlockTable(self.allocator, self.max_blocks)
                       for _ in range(engine_cfg.slots)]
        self.pcache: Optional[PrefixCache] = None
        if engine_cfg.prefix_cache:
            self.pcache = PrefixCache(
                self.allocator, max_pages=engine_cfg.max_cached_prefix_pages,
                metrics=self.metrics, tracer=self.tracer)
        self.slots: List[Optional[ServeRequest]] = [None] * engine_cfg.slots
        self.queue: List[ServeRequest] = []
        self.finished: List[ServeRequest] = []
        self.ticks = 0
        self.packed_calls = 0
        self.dispatches = 0
        self.dispatch_ticks = 0        # ticks that issued >= 1 model call
        self._arrival = 0
        m, s = self.metrics, _SITE
        self._c_ticks = m.counter("engine_ticks_total", unit="ticks", site=s)
        self._c_dispatches = m.counter("engine_dispatches_total",
                                       unit="calls", site=s)
        self._c_packed = m.counter("engine_packed_calls_total", unit="calls",
                                   site=s)
        self._c_prefill_toks = m.counter("engine_prefill_tokens_total",
                                         unit="tokens", site=s)
        self._c_decode_toks = m.counter("engine_decode_tokens_total",
                                        unit="tokens", site=s)
        self._c_preempt = m.counter("engine_preemptions_total",
                                    unit="events", site=s)
        self._c_rejected = m.counter("engine_rejected_total", unit="events",
                                     site=s)
        self._c_admitted = m.counter("engine_admitted_total", unit="events",
                                     site=s)
        self._c_finished = m.counter("engine_finished_total", unit="events",
                                     site=s)
        self._h_occ = m.histogram("engine_occupancy", unit="ratio", site=s)
        self._h_util = m.histogram("engine_page_utilization", unit="ratio",
                                   site=s)
        self._h_queue_wait = m.histogram("engine_queue_wait_ticks",
                                         unit="ticks", site=s)
        self._h_ttft_ms = m.histogram("engine_ttft_ms", unit="ms", site=s)
        self._h_ttft_ticks = m.histogram("engine_ttft_ticks", unit="ticks",
                                         site=s)
        self._h_itl_ms = m.histogram("engine_inter_token_ms", unit="ms",
                                     site=s)
        self._h_req_ticks = m.histogram("engine_request_latency_ticks",
                                        unit="ticks", site=s)
        self._h_dispatch_ms = m.histogram("engine_dispatch_ms", unit="ms",
                                          site=s)
        self._h_tok_disp = m.histogram("engine_tokens_per_dispatch",
                                       unit="tokens", site=s)
        self._h_pad_frac = m.histogram("engine_padding_fraction",
                                       unit="ratio", site=s)
        self._c_cow = m.counter("engine_cow_copies_total", unit="pages",
                                site=s)
        self._c_sig_seeded = m.counter("engine_a1_sig_seeded_total",
                                       unit="events", site=s)
        self._h_ttft_hit_ms = m.histogram("engine_ttft_hit_ms", unit="ms",
                                          site=s)
        self._h_ttft_cold_ms = m.histogram("engine_ttft_cold_ms", unit="ms",
                                           site=s)
        self._h_ttft_hit_ticks = m.histogram("engine_ttft_hit_ticks",
                                             unit="ticks", site=s)
        self._h_ttft_cold_ticks = m.histogram("engine_ttft_cold_ticks",
                                              unit="ticks", site=s)

    # ------------------------------------------------------------------ #
    def submit(self, req: ServeRequest):
        SP.check_supported(req.sampling)
        req.arrival = self._arrival
        self._arrival += 1
        req.submit_tick = self.ticks
        req.queued_tick = self.ticks
        req.submit_time = time.perf_counter()
        self.queue.append(req)
        self.tracer.begin_async("req", req.rid, prompt_len=len(req.prompt),
                                max_new=req.max_new)
        self.tracer.instant("QUEUED", rid=req.rid)

    def _admission_pages(self, r: ServeRequest) -> int:
        ctx = len(r.known())
        ahead = ctx + (r.max_new - len(r.generated)) \
            if self.ecfg.admission == "full" else ctx + 1
        return pages_needed(min(ahead, self.ecfg.max_seq),
                            self.ecfg.page_size)

    def _reject(self, r: ServeRequest):
        r.done = r.truncated = True
        r.finish_tick = self.ticks
        self._c_rejected.inc()
        self.finished.append(r)
        self.tracer.instant("REJECTED", rid=r.rid)
        self.tracer.end_async("req", r.rid, outcome="rejected")

    def _admit(self):
        while self.queue:
            try:
                free = self.slots.index(None)
            except ValueError:
                return
            r = self.queue[0]
            ctx = len(r.known())
            need = self._admission_pages(r)
            # requests that can never complete are rejected instead of
            # deadlocking the queue: the context must fit max_seq with room
            # for one token, and its pages must fit the pool
            if (ctx + 1 > self.ecfg.max_seq
                    or need > min(self.max_blocks, self.allocator.capacity)):
                self.queue.pop(0)
                self._reject(r)
                continue
            # longest-prefix match; the provisional ``share`` keeps matched
            # pages at refcount > 1 through any eviction below, so a
            # just-matched node can never be freed out from under us
            n_hit, hit_pages, hit_a1 = 0, [], {}
            if self.pcache is not None and ctx > 1:
                n_hit, hit_pages, hit_a1 = self.pcache.match(
                    np.asarray(r.known(), np.int64))
                if hit_pages:
                    self.allocator.share(hit_pages)
            need_new = need - len(hit_pages)
            if not self.allocator.can_alloc(need_new):
                if self.pcache is not None:
                    self.pcache.evict(need_new - self.allocator.free_pages)
                if not self.allocator.can_alloc(need_new):
                    if hit_pages:           # drop the provisional hold
                        self.allocator.free(hit_pages)
                    return                   # FCFS: no head-of-line skipping
            self.queue.pop(0)
            # (re-)prefill from the divergence point; a full-prompt hit
            # (n_hit == ctx) enters decode on its first tick: the last prompt
            # token runs as a one-token decode segment (its page is copied
            # out of the shared span before the write)
            r.pos = min(n_hit, ctx - 1)
            r.decoding = False
            r.prefix_hit_tokens = n_hit
            self.tables[free].adopt(hit_pages)
            self.slots[free] = r
            self._c_admitted.inc()
            self._h_queue_wait.record(self.ticks - r.queued_tick)
            self.tracer.instant("ADMITTED", rid=r.rid, slot=free,
                                wait_ticks=self.ticks - r.queued_tick)
            if self.pcache is not None:
                self.pcache.note_admission(n_hit)
            if n_hit:
                self.tracer.instant("PREFIX_HIT", rid=r.rid, slot=free,
                                    hit_tokens=n_hit,
                                    shared_pages=len(hit_pages))
                # seed the FAL signal from the cached entry on decode entry:
                # the signal at position pos is a function of tokens
                # [0, pos] alone, so the stored artifact stands in for
                # block 0's output at that position
                if r.pos == ctx - 1 and r.pos in hit_a1:
                    self.cache["a1_sig"][free] = hit_a1[r.pos].to(
                        self.cache["a1_sig"].dtype)
                    self._c_sig_seeded.inc()
            self.tracer.instant("PREFILL", rid=r.rid, slot=free,
                                context=ctx, from_pos=r.pos)
            if self.ecfg.admission == "full":
                # reservation policy: hold the worst-case pages now so this
                # request can never be preempted for page pressure
                ok = self.tables[free].ensure(
                    min(ctx + r.max_new - len(r.generated),
                        self.ecfg.max_seq))
                if not ok:
                    raise RuntimeError("reservation failed after can_alloc")

    # ------------------------------------------------------------------ #
    def _preempt(self, i: int):
        r = self.slots[i]
        # release() drops this request's references only: pages shared with
        # the prefix cache stay allocated, so re-admission matches the
        # still-cached prefix and re-prefills from the divergence point
        self.tables[i].release()
        r.pos = 0
        r.decoding = False
        r.preemptions += 1
        r.queued_tick = self.ticks
        self._c_preempt.inc()
        self.slots[i] = None
        self.queue.insert(0, r)              # front: resumes before new work
        self.tracer.instant("PREEMPTED", rid=r.rid, slot=i,
                            generated=len(r.generated))

    def _pick_victim(self, exclude: int) -> Optional[int]:
        cands = [i for i, r in enumerate(self.slots)
                 if r is not None and i != exclude]
        if not cands:
            return None
        return max(cands, key=lambda i: self.slots[i].arrival)  # youngest

    def _relieve_pressure(self, exclude: int) -> bool:
        """Free page capacity under pressure, cheapest first: evict
        refcount-free prefix-cache entries, then preempt the youngest other
        active request.  False => nothing left to take (the caller must
        preempt itself)."""
        if self.pcache is not None and self.pcache.evict(1):
            return True
        victim = self._pick_victim(exclude=exclude)
        if victim is None:
            return False
        self._preempt(victim)
        return True

    def _ensure(self, i: int, new_len: int) -> bool:
        """Grow slot i's block table to cover new_len tokens and copy (COW)
        any prefix-shared page in this tick's write range [pos, new_len) to
        a private page, relieving page pressure as needed.  False => slot i
        was itself preempted (or finished truncated) and is gone."""
        if pages_needed(new_len, self.ecfg.page_size) \
                > min(self.max_blocks, self.allocator.capacity):
            self._finish(i, truncated=True)
            return False
        while not self.tables[i].ensure(new_len):
            if not self._relieve_pressure(exclude=i):
                self._preempt(i)
                return False
        if self.pcache is None:
            return True
        # the tick scatters K/V at positions [pos, new_len): a page there
        # still shared with the tree (or another sharer) gets a private
        # device copy first, so the write never reaches another history
        r = self.slots[i]
        while True:
            blk = self.tables[i].first_shared_block(r.pos, new_len)
            if blk is None:
                return True
            got = self.allocator.alloc(1)
            if got is None:
                if not self._relieve_pressure(exclude=i):
                    self._preempt(i)
                    return False
                continue
            old = self.tables[i].pages[blk]
            with self.tracer.span("engine.cow", annotate=True,
                                  page_from=old, page_to=got[0]):
                M.copy_paged_pages(self.cache, [old], [got[0]])
            self.tables[i].replace(blk, got[0])
            self._c_cow.inc()
            self.tracer.instant("COW", rid=r.rid, slot=i, block=blk,
                                page_from=old, page_to=got[0])

    def _park_prefix(self, i: int, r: ServeRequest):
        """Insert the finished request's page-aligned written prefix (and
        its captured a1_sig at the prompt's last position) into the radix
        tree.  Runs before ``release()``: ``insert`` takes the tree's own
        reference on newly cached pages, release then drops the table's."""
        ps = self.ecfg.page_size
        n_ins = (r.pos // ps) * ps       # only fully written pages
        if n_ins <= 0:
            return
        a1 = {}
        q = len(r.prompt) - 1
        if r.prefix_sig is not None and q < n_ins:
            a1[q] = r.prefix_sig
        adopted = self.pcache.insert(
            np.asarray(r.known()[:n_ins], np.int64),
            self.tables[i].pages[:n_ins // ps], a1=a1,
            pinned=r.pin_prefix)
        if adopted:
            self.tracer.instant("PREFIX_PARKED", rid=r.rid,
                                pages=adopted, tokens=n_ins)

    def _finish(self, i: int, truncated: bool = False):
        r = self.slots[i]
        if self.pcache is not None:
            self._park_prefix(i, r)
        r.done = True
        r.truncated = truncated
        r.finish_tick = self.ticks
        self.tables[i].release()
        self.slots[i] = None
        self.finished.append(r)
        self._c_finished.inc()
        self._h_req_ticks.record(r.finish_tick - r.submit_tick)
        self.tracer.instant("FINISHED", rid=r.rid, truncated=truncated,
                            generated=len(r.generated))
        self.tracer.end_async(
            "req", r.rid, outcome="truncated" if truncated else "finished")

    # ------------------------------------------------------------------ #
    def _plan_pack(self) -> PackedTick:
        """Each active lane offers up to ``prefill_chunk`` tokens when
        prefilling, or its one pending token when decoding."""
        lists, poss, dec = [], [], []
        for r in self.slots:
            if r is None:
                lists.append([])
                poss.append(0)
                dec.append(False)
                continue
            lists.append(r.known()[r.pos:r.pos + self.ecfg.prefill_chunk])
            poss.append(r.pos)
            dec.append(len(r.known()) - r.pos == 1)
        return pack_tokens(lists, poss, dec, self.budget,
                           self.ecfg.max_prefill_tokens, rotate=self.ticks)

    def _consume_one(self, i: int, tok: int, now: float):
        """Append one sampled token to lane i: TTFT/ITL series and finish
        checks."""
        r = self.slots[i]
        r.generated.append(tok)
        if len(r.generated) == 1:
            if self.pcache is not None and r.prefix_sig is None:
                # block 1's first-attention signal at position
                # len(prompt) - 1 (this tick's seg_last row), the prefix
                # artifact _park_prefix caches at finish
                r.prefix_sig = self.cache["a1_sig"][i].clone()
            ttft_ms = (now - r.submit_time) * 1e3
            ttft_ticks = self.ticks - r.submit_tick
            self._h_ttft_ms.record(ttft_ms)
            self._h_ttft_ticks.record(ttft_ticks)
            if self.pcache is not None:
                hot = r.prefix_hit_tokens > 0
                (self._h_ttft_hit_ms if hot
                 else self._h_ttft_cold_ms).record(ttft_ms)
                (self._h_ttft_hit_ticks if hot
                 else self._h_ttft_cold_ticks).record(ttft_ticks)
        elif r.last_token_time:
            self._h_itl_ms.record((now - r.last_token_time) * 1e3)
        r.last_token_time = now
        if not r.decoding:
            r.decoding = True
            self.tracer.instant("DECODE", rid=r.rid, slot=i,
                                generated=len(r.generated))
        if len(r.generated) >= r.max_new:
            self._finish(i)
        elif len(r.known()) >= self.ecfg.max_seq:
            self._finish(i, truncated=True)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_packed(self, pt: PackedTick):
        """One model call over the packed buffer; consume a sampled token
        for every lane whose context completed this call."""
        S = self.ecfg.slots
        ids = [i for i in range(S) if pt.n_taken[i] > 0]
        self.dispatches += 1
        self._c_dispatches.inc()
        self._h_occ.record(len(ids) / S)
        T = pt.tokens.shape[0]
        self._h_tok_disp.record(pt.n_live)
        self._h_pad_frac.record(1.0 - pt.n_live / T)
        bt = np.stack([t.as_row() for t in self.tables])
        t0 = time.perf_counter()
        with self.tracer.span("engine.dispatch", annotate=True,
                              lanes=len(ids), live_tokens=pt.n_live,
                              budget=T):
            _, nxt, self.cache = self.step_fn(
                self.params, self.cache, self._to_device(pt.tokens),
                self._to_device(pt.tok_slot), self._to_device(pt.tok_pos),
                self._to_device(bt), self._to_device(pt.seg_last))
            nxt_np = nxt.cpu().numpy()
        self._h_dispatch_ms.record((time.perf_counter() - t0) * 1e3)
        for i in ids:
            r = self.slots[i]
            adv = int(pt.n_taken[i])
            if len(r.known()) - r.pos == 1:
                self._c_decode_toks.inc(adv)
            else:
                self._c_prefill_toks.inc(adv)
            r.pos += adv
        now = time.perf_counter()
        for i in ids:
            if self.slots[i].pos == len(self.slots[i].known()):
                self._consume_one(i, int(nxt_np[i]), now)

    # ------------------------------------------------------------------ #
    def step(self):
        """One engine tick: admit, then ONE packed model call serving every
        active lane at its own phase."""
        self.ticks += 1
        self._c_ticks.inc()
        with self.tracer.span("engine.tick", tick=self.ticks):
            self._admit()
            d0 = self.dispatches
            self._step_packed()
            if self.dispatches > d0:
                self.dispatch_ticks += 1
            self._h_util.record(self.allocator.stats()["utilization"])

    def _step_packed(self):
        """Page growth (``_ensure``) can preempt or truncate lanes mid-plan;
        every eviction frees budget, so the pack is re-planned until the
        surviving lanes' plan sticks (at most slots + 1 rounds)."""
        for _ in range(self.ecfg.slots + 1):
            pt = self._plan_pack()
            if pt.n_live == 0:
                return
            replan = False
            for i in range(self.ecfg.slots):
                if pt.n_taken[i] == 0 or self.slots[i] is None:
                    continue
                if not self._ensure(i, self.slots[i].pos
                                    + int(pt.n_taken[i])):
                    replan = True             # slot i preempted/truncated
                    break
            if not replan and all(
                    self.slots[i] is not None
                    for i in range(self.ecfg.slots) if pt.n_taken[i] > 0):
                self.packed_calls += 1
                self._c_packed.inc()
                self._run_packed(pt)
                return

    def run(self, max_ticks: Optional[int] = None) -> List[ServeRequest]:
        while any(s is not None for s in self.slots) or self.queue:
            if max_ticks is not None and self.ticks >= max_ticks:
                break
            self.step()
        return self.finished

    # ------------------------------------------------------------------ #
    def reset_stats(self):
        """Zero every counter and series (and drop trace events) while
        keeping live requests and page state."""
        self.ticks = 0
        self.packed_calls = 0
        self.dispatches = self.dispatch_ticks = 0
        self.metrics.reset()
        self.tracer.clear()
        self.allocator.peak_in_use = self.allocator.in_use

    def stats(self) -> dict:
        frag = sum(self.tables[i].internal_fragmentation(self.slots[i].pos)
                   for i in range(self.ecfg.slots)
                   if self.slots[i] is not None)

        def pcts(h):
            return {"p50": h.percentile(50), "p99": h.percentile(99),
                    "mean": h.mean, "count": h.count}

        return {
            "ticks": self.ticks,
            "packed_calls": self.packed_calls,
            "dispatches": self.dispatches,
            "dispatch_ticks": self.dispatch_ticks,
            "dispatches_per_tick":
                self.dispatches / max(self.dispatch_ticks, 1),
            "mean_occupancy": self._h_occ.mean,
            "token_budget": self.budget,
            "tokens_per_dispatch": pcts(self._h_tok_disp),
            "padding_fraction": pcts(self._h_pad_frac),
            "prefill_tokens": self._c_prefill_toks.value,
            "decode_tokens": self._c_decode_toks.value,
            "preemptions": self._c_preempt.value,
            "rejected": self._c_rejected.value,
            "mean_page_utilization": self._h_util.mean,
            "internal_fragmentation": frag,
            "pages": self.allocator.stats(),
            "ttft_ms": pcts(self._h_ttft_ms),
            "ttft_ticks": pcts(self._h_ttft_ticks),
            "inter_token_ms": pcts(self._h_itl_ms),
            "queue_wait_ticks": pcts(self._h_queue_wait),
            "request_latency_ticks": pcts(self._h_req_ticks),
            "dispatch_ms": pcts(self._h_dispatch_ms),
            # prefix-sharing cut (None without EngineConfig.prefix_cache):
            # the tree and its hit rates, allocator sharing, COW copies,
            # a1_sig seedings, and TTFT split hot (a hit at admission) and
            # cold
            "prefix": None if self.pcache is None else {
                **self.pcache.stats(),
                "shared_pages": self.allocator.shared_pages,
                "cow_copies": self._c_cow.value,
                "a1_sig_seeded": self._c_sig_seeded.value,
                "ttft_hit_ms": pcts(self._h_ttft_hit_ms),
                "ttft_cold_ms": pcts(self._h_ttft_cold_ms),
                "ttft_hit_ticks": pcts(self._h_ttft_hit_ticks),
                "ttft_cold_ticks": pcts(self._h_ttft_cold_ticks),
            },
            "metrics": self.metrics.to_dict(),
        }

    @property
    def preemptions(self) -> int:
        return self._c_preempt.value

    @property
    def rejected(self) -> int:
        return self._c_rejected.value
