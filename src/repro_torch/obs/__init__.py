"""Observability of the PyTorch port: a metrics registry (``metrics``), a
Chrome-trace span tracer (``trace``), both copies of ``repro.obs``, and
run-metadata stamping (``runmeta``: git sha, torch / CUDA versions, the
card's name, count and power limit) for every benchmark artifact.

Kernel-dispatch telemetry lives in ``kernels.ops``: every dispatcher records
which path ran (``cuda-kernel`` or ``cpu-plain``) per call site and counts
``kernel_dispatch_total.<site>.<path>`` in executed calls.

Metric-name reference
=====================

======================================  =========  =======  ==========================================
name                                    type       unit     emitting site
======================================  =========  =======  ==========================================
engine_ticks_total                      counter    ticks    serve/scheduler.py  PagedEngine.step
engine_dispatches_total                 counter    calls    serve/scheduler.py  PagedEngine._run_packed
engine_packed_calls_total               counter    calls    serve/scheduler.py  PagedEngine._step_packed
engine_prefill_tokens_total             counter    tokens   serve/scheduler.py  PagedEngine._run_packed
engine_decode_tokens_total              counter    tokens   serve/scheduler.py  PagedEngine._run_packed
engine_preemptions_total                counter    events   serve/scheduler.py  PagedEngine._preempt
engine_rejected_total                   counter    events   serve/scheduler.py  PagedEngine._reject
engine_admitted_total                   counter    events   serve/scheduler.py  PagedEngine._admit
engine_finished_total                   counter    events   serve/scheduler.py  PagedEngine._finish
engine_occupancy                        histogram  ratio    serve/scheduler.py  PagedEngine._run_packed
engine_tokens_per_dispatch              histogram  tokens   serve/scheduler.py  PagedEngine._run_packed
engine_padding_fraction                 histogram  ratio    serve/scheduler.py  PagedEngine._run_packed
engine_page_utilization                 histogram  ratio    serve/scheduler.py  PagedEngine.step
engine_queue_wait_ticks                 histogram  ticks    serve/scheduler.py  PagedEngine._admit
engine_ttft_ms                          histogram  ms       serve/scheduler.py  PagedEngine._run_packed
engine_ttft_ticks                       histogram  ticks    serve/scheduler.py  PagedEngine._run_packed
engine_inter_token_ms                   histogram  ms       serve/scheduler.py  PagedEngine._run_packed
engine_request_latency_ticks            histogram  ticks    serve/scheduler.py  PagedEngine._finish
engine_dispatch_ms                      histogram  ms       serve/scheduler.py  PagedEngine._run_packed
engine_cow_copies_total                 counter    pages    serve/scheduler.py  PagedEngine._ensure
engine_ttft_hit_ms / _cold_ms           histogram  ms       serve/scheduler.py  PagedEngine._run_packed
engine_ttft_hit_ticks / _cold_ticks     histogram  ticks    serve/scheduler.py  PagedEngine._run_packed
engine_spec_accepted_total              counter    tokens   serve/scheduler.py  PagedEngine._consume_spec_lane
engine_spec_rejected_total              counter    tokens   serve/scheduler.py  PagedEngine._consume_spec_lane
engine_spec_accepted_len                histogram  tokens   serve/scheduler.py  PagedEngine._consume_spec_lane
pages_in_use / pages_shared             gauge      pages    serve/paged_cache.py PageAllocator
engine_kv_bytes_in_use                  gauge      bytes    serve/paged_cache.py PageAllocator
pages_alloc_total / _free_total         counter    pages    serve/paged_cache.py PageAllocator
pages_shared_total                      counter    pages    serve/paged_cache.py PageAllocator.share
prefix_hits_total / prefix_misses_total counter    admissions serve/prefix_cache.py PrefixCache.note_admission
prefix_hit_tokens                       histogram  tokens   serve/prefix_cache.py PrefixCache.note_admission
prefix_inserted_pages_total             counter    pages    serve/prefix_cache.py PrefixCache.insert
prefix_evicted_pages_total              counter    pages    serve/prefix_cache.py PrefixCache.evict
prefix_cached_pages                     gauge      pages    serve/prefix_cache.py PrefixCache
batcher_ticks_total                     counter    ticks    serve/decode.py     ContinuousBatcher.step
batcher_dispatches_total                counter    calls    serve/decode.py     ContinuousBatcher.step
batcher_occupancy                       histogram  ratio    serve/decode.py     ContinuousBatcher.step
kernel_dispatch_total.<site>.<path>     counter    calls    kernels/ops.py      every dispatcher
train_steps_total                       counter    steps    train/trainer.py    train()
train_tokens_total                      counter    tokens   train/trainer.py    train()
train_step_ms                           histogram  ms       train/trainer.py    train()
train_<metric>                          gauge      -        train/trainer.py    every logged step scalar
train_eval_ppl                          gauge      ppl      train/trainer.py    eval cadence
======================================  =========  =======  ==========================================
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from repro_torch.obs.runmeta import run_metadata  # noqa: F401
from repro_torch.obs.trace import NULL_TRACER, Tracer  # noqa: F401
