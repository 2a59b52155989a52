"""Continuous-batching scheduler over the paged KV cache, on torch.

Port of ``repro/serve/scheduler.py``: admission control ('prompt': prompt
+ 1 token; 'full': prompt + max_new, no preemption), TOKEN-PACKED ticks
(one model call per tick over a flat ``(token_budget,)`` buffer where token
t belongs to lane ``tok_slot[t]`` at position ``tok_pos[t]``; decode lanes
are packed first, prefill lanes share the rest round-robin), per-request
seeded sampling after the head (``serve/sampling.py``; the engine picks the
greedy, fast or full-sort sampler host-side per tick), preemption of the
youngest other request under page pressure, and rejection of requests
that can never fit.
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
kernel) and parks every finished request's prefix.

Self-speculative decoding (``EngineConfig.spec_tokens``): each eligible
decode lane packs its pending token and ``spec_tokens - 1`` placeholder rows
as one segment.  Within the tick's one model call (``make_spec_step``) the
early-exit draft (block 0 and ``draft_blocks - 1`` later layers) proposes
the placeholders one by one, sampled with the same ``fold_in(seed,
position)`` keys the verify will use, and the full-depth packed forward
verifies the whole segment; the host accepts the longest matching prefix
plus the bonus target and rewinds the rejected page growth
(``BlockTable.shrink``).  Exact-match acceptance keeps greedy and seeded
streams equal to non-speculative decode.  On a tick where no lane
speculates the draft does not run.

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
def make_packed_step(cfg, plan=None, *, sampler=None):
    """The packed tick (``scheduler.py:106``): (params, cache, tokens (T,),
    tok_slot (T,), tok_pos (T,), block_tables (S, Tb), seg_last (S,),
    temps, top_ks, top_ps, seeds, sample_pos (S,)) -> (seg_logits (S, V),
    next_tokens (S,) int32, cache).

    Runs the blocks to hidden states, gathers each segment's last token
    (``seg_last``, -1 for lanes sitting the tick out), applies the LM head
    to the (S, 1, D) gather only and samples each lane with its parameters
    at position ``sample_pos`` (``sampler``: a ``sampling.sample_tokens``
    drop-in; None is ``sample_tokens``).  Lanes sitting out get a zeroed
    row before the head and the -1 sentinel instead of a sampled id.  The
    cache is updated in place."""
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.PAGED)
    plan.validate(cfg)
    samp = sampler if sampler is not None else SP.sample_tokens

    @torch.no_grad()
    def step(params, cache, tokens, tok_slot, tok_pos, block_tables,
             seg_last, temps, top_ks, top_ps, seeds, sample_pos):
        batch = {"tokens": tokens, "tok_slot": tok_slot, "tok_pos": tok_pos,
                 "block_tables": block_tables, "seg_last": seg_last}
        hidden, cache = M.paged_decode_step(params, cfg, batch, cache, plan,
                                            want="hidden")
        active = seg_last >= 0
        h_seg = hidden[0, seg_last.clamp(min=0).long()]           # (S, D)
        h_seg = torch.where(active[:, None], h_seg,
                            torch.zeros_like(h_seg))
        logits = M.lm_head(params, cfg, h_seg[:, None])[:, 0]     # (S, V)
        nxt = samp(logits, temps, top_ks, top_ps, seeds, sample_pos)
        nxt = torch.where(active, nxt, torch.full_like(nxt, -1))
        return logits, nxt, cache

    return step


def make_spec_step(cfg, plan=None, *, spec_tokens, draft_blocks,
                   sampler=None):
    """The self-speculative packed tick (``scheduler.py:159``), still one
    model call per tick: (params, cache, tokens (T,), tok_slot (T,),
    tok_pos (T,), block_tables (S, Tb), seg_last (S,), spec_mask (S,),
    temps, top_ks, top_ps, seeds, draft=True) -> (targets (S, n), fed
    (S, n), cache).

    Lanes with ``spec_mask`` set are decode lanes whose segment spans
    n == ``spec_tokens`` rows: the pending token, then n-1 placeholders at
    positions pos+1..pos+n-1.  With ``draft`` (the host passes whether any
    lane speculates), n-1 draft iterations each run row ``seg_start + j``
    of every spec lane as a flat (S,) packed batch (other lanes ride as
    padding, tok_pos == -1) through ``model.paged_spec_draft``, sample a
    proposal with the key the verify will use at that position, and plant
    it in row ``seg_start + j + 1``.  The verify is the full-depth packed
    forward over the whole buffer; the head runs on each segment's last n
    rows (``model.lm_head_segment_tail``) and ``targets[s, j]`` is sampled
    at the position after row ``rows[s, j]``.  ``fed`` holds the tokens
    those rows carried.  Non-spec lanes' only live column is the last;
    dead columns are zeroed before the head and return -1."""
    n = int(spec_tokens)
    if n < 2:
        raise ValueError("spec_tokens >= 2 (1 proposal minimum)")
    plan = ExecutionPlan.resolve(plan).with_phase(Phase.PAGED)
    plan.validate(cfg)
    samp = sampler if sampler is not None else SP.sample_tokens

    @torch.no_grad()
    def step(params, cache, tokens, tok_slot, tok_pos, block_tables,
             seg_last, spec_mask, temps, top_ks, top_ps, seeds, draft=True):
        T, S = tokens.shape[0], seg_last.shape[0]
        seg_start = seg_last - (n - 1)
        lane = torch.arange(S, dtype=torch.int32, device=tokens.device)
        # one row past the buffer takes the writes of non-spec lanes
        toks = torch.cat([tokens, tokens.new_zeros(1)])
        for j in range(n - 1 if draft else 0):
            row = torch.where(spec_mask, (seg_start + j).clamp(min=0),
                              0).long()
            dpos = torch.where(spec_mask, tok_pos[row], -1)
            dbatch = {"tokens": torch.where(spec_mask, toks[row], 0),
                      "tok_slot": lane, "tok_pos": dpos,
                      "block_tables": block_tables}
            dh, cache = M.paged_spec_draft(params, cfg, dbatch, cache, plan,
                                           draft_blocks=draft_blocks)
            h = torch.where(spec_mask[:, None], dh[0], torch.zeros_like(dh[0]))
            dlogits = M.lm_head(params, cfg, h[:, None])[:, 0]    # (S, V)
            dnext = samp(dlogits, temps, top_ks, top_ps, seeds, dpos + 1)
            wrow = torch.where(spec_mask, seg_start + j + 1, T).long()
            toks.scatter_(0, wrow, dnext.to(toks.dtype))
        toks = toks[:T]
        batch = {"tokens": toks, "tok_slot": tok_slot, "tok_pos": tok_pos,
                 "block_tables": block_tables, "seg_last": seg_last}
        hidden, cache = M.paged_decode_step(params, cfg, batch, cache, plan,
                                            want="hidden")
        logits, rows = M.lm_head_segment_tail(params, cfg, hidden,
                                              seg_last, n)      # (S, n, V)
        col = torch.arange(n, device=rows.device)[None, :]
        live = ((seg_last >= 0)[:, None] & (rows >= 0)
                & (spec_mask[:, None] | (col == n - 1)))
        at = rows.clamp(min=0).long()
        rep = lambda a: a.repeat_interleave(n)                    # noqa: E731
        tgt = samp(logits.reshape(S * n, -1), rep(temps), rep(top_ks),
                   rep(top_ps), rep(seeds),
                   (tok_pos[at] + 1).reshape(-1)).reshape(S, n)
        tgt = torch.where(live, tgt, -1)
        fed = torch.where(live, toks[at], -1)
        return tgt, fed, cache

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
    """Paged-engine knobs."""
    page_size: int = 16
    num_pages: int = 64                # pool size incl. scratch page 0
    slots: int = 4                     # concurrent batch lanes
    prefill_chunk: int = 16            # max prefill tokens per lane per tick
    # flat tokens per packed call; 0 = auto (slots * max(1, spec_tokens)
    # + prefill_chunk - 1)
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
    # self-speculative decoding: the rows each decode lane packs a tick (its
    # pending token and spec_tokens - 1 proposals; 0 = off, >= 2 on), and
    # the leading blocks (block 0 included) the draft runs before its head
    spec_tokens: int = 0
    draft_blocks: int = 2


class PagedEngine:
    """Slot-based continuous batching over paged KV (the dense and MoE
    decoders, GQA or MLA; a VLM config with an image prefix raises).

    ``device``: where the model and cache live; None means ``cuda`` and
    raises without one.  ``metrics``: a ``MetricsRegistry`` (one per engine
    when omitted).  ``tracer``: a ``Tracer``; the default records nothing."""

    def __init__(self, cfg, params, engine_cfg: EngineConfig = EngineConfig(),
                 plan=None, metrics: Optional[MetricsRegistry] = None,
                 tracer=None, device=None):
        M.check_supported(cfg)
        if cfg.n_image_tokens:
            # paged_decode_step takes image_embeds, but a request carries
            # only text: refuse rather than serve the image prefix as text
            # tokens (reference scheduler.py:442-448)
            raise NotImplementedError(
                "PagedEngine serves text-only requests; vlm image prefixes "
                "need image_embeds plumbed through ServeRequest")
        if engine_cfg.admission not in ("prompt", "full"):
            raise ValueError(f"admission must be 'prompt' or 'full', got "
                             f"{engine_cfg.admission!r}")
        self.device = M.resolve_device(device)
        self.cfg, self.params, self.ecfg = cfg, params, engine_cfg
        self.spec = int(engine_cfg.spec_tokens)
        if self.spec:
            if self.spec < 2:
                raise ValueError(
                    f"spec_tokens={self.spec}: needs >= 2 (the lane's "
                    f"pending token + at least one proposal), or 0 = off")
            if not 1 <= engine_cfg.draft_blocks < cfg.n_layers:
                raise ValueError(
                    f"draft_blocks={engine_cfg.draft_blocks} must satisfy "
                    f"1 <= draft_blocks < n_layers={cfg.n_layers}")
        # every decode lane packs spec_tokens rows under speculation
        seg = max(1, self.spec)
        self.budget = engine_cfg.token_budget or (
            engine_cfg.slots * seg + engine_cfg.prefill_chunk - 1)
        if self.budget < engine_cfg.slots * seg:
            raise ValueError(
                f"token_budget={self.budget} cannot keep all "
                f"{engine_cfg.slots} slots live (need >= slots * "
                f"{seg} packed rows per decode lane)")
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
        # the tick's model call with the greedy, fast or full-sort sampler,
        # built on first use (``_step_for``)
        self._step_fns = {}
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
        self._c_spec_acc = m.counter("engine_spec_accepted_total",
                                     unit="tokens", site=s)
        self._c_spec_rej = m.counter("engine_spec_rejected_total",
                                     unit="tokens", site=s)
        self._h_spec_len = m.histogram("engine_spec_accepted_len",
                                       unit="tokens", site=s)

    # ------------------------------------------------------------------ #
    def submit(self, req: ServeRequest):
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
    def _spec_eligible(self, r: ServeRequest) -> bool:
        """A decode lane speculates when speculation is on, it has sampled
        its first token (the first-token tick runs plainly, so the prefix
        cache's a1_sig is captured at the prompt's last position), and a
        whole n-row proposal fits under ``max_seq``."""
        return (self.spec > 0 and len(r.generated) > 0
                and r.pos + self.spec <= self.ecfg.max_seq)

    def _plan_pack(self) -> PackedTick:
        """Each active lane offers up to ``prefill_chunk`` tokens when
        prefilling, its one pending token when decoding, or, when it
        speculates, its pending token and ``spec_tokens - 1`` placeholder
        rows the draft fills in on the device."""
        lists, poss, dec = [], [], []
        for r in self.slots:
            if r is None:
                lists.append([])
                poss.append(0)
                dec.append(False)
                continue
            decoding = len(r.known()) - r.pos == 1
            if decoding and self._spec_eligible(r):
                lists.append(r.known()[r.pos:] + [0] * (self.spec - 1))
            else:
                lists.append(r.known()[r.pos:r.pos + self.ecfg.prefill_chunk])
            poss.append(r.pos)
            dec.append(decoding)
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

    def _consume_spec_lane(self, i: int, tgt_row: np.ndarray,
                           fed_row: np.ndarray, now: float):
        """Accept the longest prefix of lane i's n-1 proposals that match
        their targets, plus the bonus target after it, and rewind the
        rejected page growth.  ``tgt_row[j]`` is the model's token at
        position pos+j+1, ``fed_row[j]`` what was packed at pos+j (row 0
        the pending token, rows 1.. the proposals)."""
        n = self.spec
        r = self.slots[i]
        a = 0
        while a < n - 1 and int(fed_row[a + 1]) == int(tgt_row[a]):
            a += 1
        # the stream must be what sequential decode emits, cut at the same
        # finish boundaries
        room = min(r.max_new - len(r.generated),
                   self.ecfg.max_seq - len(r.known()))
        emit = [int(t) for t in tgt_row[:a + 1][:room]]
        r.generated.extend(emit)
        # positions pos..pos+len(emit)-1 now hold verified context; shrink
        # drops this table's references past them (shared prefix pages
        # survive); the rejected rows' K/V is invisible until re-fed
        r.pos += len(emit)
        dropped = self.tables[i].shrink(r.pos)
        self._c_decode_toks.inc(len(emit))
        self._c_spec_acc.inc(a)
        self._c_spec_rej.inc(n - 1 - a)
        self._h_spec_len.record(len(emit))
        if dropped:
            self.tracer.instant("SPEC_ROLLBACK", rid=r.rid, slot=i,
                                pages=dropped, accepted=a)
        if r.last_token_time:
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

    def _sampler_kind(self, ids) -> str:
        """'greedy' when every lane of the tick is greedy, 'fast' when every
        lane satisfies ``sampling.fast_eligible``, else 'full'."""
        sps = [self.slots[i].sampling for i in ids]
        if all(sp.temperature <= 0.0 for sp in sps):
            return "greedy"
        if all(SP.fast_eligible(sp, self.cfg.vocab) for sp in sps):
            return "fast"
        return "full"

    def _step_for(self, kind: str):
        """The tick's model call with the ``kind`` sampler (three variants
        at most per engine; the reference builds its fast and full ones)."""
        if kind not in self._step_fns:
            samp = {"greedy": SP.greedy_sampler,
                    "fast": SP.fast_sampler(self.cfg.vocab),
                    "full": SP.sample_tokens}[kind]
            if self.spec:
                self._step_fns[kind] = make_spec_step(
                    self.cfg, self.plan, spec_tokens=self.spec,
                    draft_blocks=self.ecfg.draft_blocks, sampler=samp)
            else:
                self._step_fns[kind] = make_packed_step(self.cfg, self.plan,
                                                        sampler=samp)
        return self._step_fns[kind]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_packed(self, pt: PackedTick):
        """One model call over the packed buffer (forward and sampling);
        consume the samples of every lane whose context completed this call
        (under speculation a spec lane may emit up to n tokens)."""
        S = self.ecfg.slots
        ids = [i for i in range(S) if pt.n_taken[i] > 0]
        self.dispatches += 1
        self._c_dispatches.inc()
        self._h_occ.record(len(ids) / S)
        T = pt.tokens.shape[0]
        self._h_tok_disp.record(pt.n_live)
        self._h_pad_frac.record(1.0 - pt.n_live / T)
        bt = np.stack([t.as_row() for t in self.tables])
        temps = np.zeros((S,), np.float32)
        ks = np.zeros((S,), np.int32)
        ps = np.ones((S,), np.float32)
        seeds = np.zeros((S,), np.int32)
        poss = np.zeros((S,), np.int32)
        spec_mask = np.zeros((S,), bool)
        for i in ids:
            r = self.slots[i]
            sp = r.sampling
            temps[i], ks[i], ps[i] = sp.temperature, sp.top_k, sp.top_p
            seeds[i] = sp.seed
            # position of the would-be new token (len(known()) exactly when
            # this call completes the request's context)
            poss[i] = r.pos + int(pt.n_taken[i])
            # only _plan_pack's spec-eligible decode lanes pack > 1 row
            spec_mask[i] = (len(r.known()) - r.pos == 1
                            and int(pt.n_taken[i]) > 1)
        step_fn = self._step_for(self._sampler_kind(ids))
        dev = self._to_device
        args = (self.params, self.cache, dev(pt.tokens), dev(pt.tok_slot),
                dev(pt.tok_pos), dev(bt), dev(pt.seg_last))
        samp_args = (dev(temps), dev(ks), dev(ps), dev(seeds))
        t0 = time.perf_counter()
        if self.spec:
            with self.tracer.span("engine.dispatch", annotate=True,
                                  lanes=len(ids), live_tokens=pt.n_live,
                                  budget=T, spec_lanes=int(spec_mask.sum())):
                tgt, fed, self.cache = step_fn(
                    *args, dev(spec_mask), *samp_args,
                    draft=bool(spec_mask.any()))
                tgt_np, fed_np = tgt.cpu().numpy(), fed.cpu().numpy()
            self._h_dispatch_ms.record((time.perf_counter() - t0) * 1e3)
            now = time.perf_counter()
            for i in ids:
                r = self.slots[i]
                adv = int(pt.n_taken[i])
                if spec_mask[i]:
                    # only the accepted prefix advances the lane
                    self._consume_spec_lane(i, tgt_np[i], fed_np[i], now)
                    continue
                if len(r.known()) - r.pos == 1:
                    self._c_decode_toks.inc(adv)
                else:
                    self._c_prefill_toks.inc(adv)
                r.pos += adv
                if r.pos == len(r.known()):
                    # a non-spec lane's sample is the last column
                    self._consume_one(i, int(tgt_np[i][self.spec - 1]), now)
            return
        with self.tracer.span("engine.dispatch", annotate=True,
                              lanes=len(ids), live_tokens=pt.n_live,
                              budget=T):
            _, nxt, self.cache = step_fn(*args, *samp_args, dev(poss))
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
            # self-speculative cut (None when spec_tokens == 0): proposal
            # acceptance and the emitted (accepted + bonus) length a tick
            "spec": None if not self.spec else {
                "spec_tokens": self.spec,
                "draft_blocks": self.ecfg.draft_blocks,
                "proposals_accepted": self._c_spec_acc.value,
                "proposals_rejected": self._c_spec_rej.value,
                "acceptance_rate": self._c_spec_acc.value / max(
                    self._c_spec_acc.value + self._c_spec_rej.value, 1),
                "accepted_len": pcts(self._h_spec_len),
            },
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
