"""Serving example of the PyTorch port: the paged continuous-batching
engine over a FAL model.  Twin of ``examples/serve_requests.py``: a ragged
stream of requests drained through fixed batch slots with ONE token-packed
dispatch per engine tick (a flat ``(token_budget,)`` buffer where each token
carries its lane and position, decode tokens packed first); batched
outputs checked against lone-request decoding; the engine's latency and
packing metrics and the kernels' dispatch paths; a Chrome trace of the run;
the ``max_prefill_tokens`` fairness knob, which changes pacing and never a
token; the radix prefix cache (hits adopt cached KV pages by refcount,
prefill only their tail, seed the FAL first-attention signal, and
copy-on-write keeps sharers bit-identical); int8 KV pages; and the
dual-branch (MHA || MLP) engine.

Run on the card:  PYTHONPATH=src python examples/torch_serve_requests.py
On the CPU (the kernels' plain versions): add ``--device cpu``.
"""
import argparse
import time

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels.ops import dispatch_paths, reset_dispatch_paths
from repro_torch.models import model as M
from repro_torch.obs.trace import Tracer, validate_chrome_trace
from repro_torch.serve.scheduler import EngineConfig, PagedEngine, ServeRequest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", default="TRACE_torch_example.json",
                    help="where the Chrome trace of the first run goes")
    args = ap.parse_args(argv)
    device = M.resolve_device(args.device)

    cfg = get_config("llama3.2-3b").reduced().replace(connection="fal")
    params = M.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(42)
    plan = ExecutionPlan.single_device()

    def engine_of(tracer=None, **kw):
        ecfg = dict(page_size=8, num_pages=48, slots=4, prefill_chunk=8,
                    max_seq=128)
        ecfg.update(kw)
        return PagedEngine(cfg, params, EngineConfig(**ecfg), plan=plan,
                           tracer=tracer, device=device)

    # --- submit 10 ragged requests through 4 slots -------------------------
    # the engine stores a typed ExecutionPlan (phase pinned to 'paged');
    # single_device() = no group, no TP.  The Tracer records per-tick /
    # per-dispatch spans and each request's lifecycle events
    tracer = Tracer(enabled=True)
    engine = engine_of(tracer)
    reset_dispatch_paths()                # the paths of this run alone
    prompts = [rng.integers(0, cfg.vocab, 4 + i % 7) for i in range(10)]
    for i, p in enumerate(prompts):
        engine.submit(ServeRequest(rid=i, prompt=p, max_new=8 + 3 * (i % 3)))
    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    total = sum(len(r.generated) for r in done)
    st = engine.stats()
    print(f"served {len(done)} requests, {total} tokens in {dt:.1f}s "
          f"({total/dt:.0f} tok/s; {st['dispatches']} dispatches in "
          f"{st['ticks']} ticks = {st['dispatches_per_tick']:.2f}/tick, "
          f"occupancy {st['mean_occupancy']:.2f}, "
          f"peak pages {st['pages']['peak_in_use']}/"
          f"{st['pages']['capacity']})")
    print(f"packed ticks: budget {st['token_budget']} tokens/dispatch, live "
          f"p50 {st['tokens_per_dispatch']['p50']:.0f} "
          f"p99 {st['tokens_per_dispatch']['p99']:.0f}, padding fraction "
          f"p50 {st['padding_fraction']['p50']:.2f}")
    print(f"engine-measured latency: ttft p50 {st['ttft_ms']['p50']:.0f}ms "
          f"p99 {st['ttft_ms']['p99']:.0f}ms, inter-token p50 "
          f"{st['inter_token_ms']['p50']:.0f}ms, queue wait p50 "
          f"{st['queue_wait_ticks']['p50']:.1f} ticks")
    paths = dispatch_paths()
    print(f"kernel dispatch paths (runtime-measured): {paths}")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        print(f"  req {r.rid}: prompt {list(r.prompt)} -> {r.generated}")

    # the trace is standard Chrome trace-event JSON: load it at
    # ui.perfetto.dev
    n_events = validate_chrome_trace(tracer.export())
    tracer.write(args.trace)
    print(f"wrote {args.trace} ({n_events} events; open in ui.perfetto.dev)")

    # --- correctness: batched == lone --------------------------------------
    lone = engine_of(slots=1)
    probe = sorted(done, key=lambda r: r.rid)[0]
    lone.submit(ServeRequest(rid=0, prompt=probe.prompt,
                             max_new=len(probe.generated)))
    ref = lone.run()[0].generated
    assert ref == probe.generated, (ref, probe.generated)
    print("continuous batching == lone decoding ✓")

    # --- fairness knob: cap prefill tokens per tick ------------------------
    # max_prefill_tokens caps the PREFILL share of a tick (decode tokens
    # are packed first and never displaced): pacing changes, tokens never do
    burst_prompts = [rng.integers(0, cfg.vocab, 40 + 8 * i)
                     for i in range(6)]

    def serve_burst(max_prefill):
        eng = engine_of(num_pages=64, max_prefill_tokens=max_prefill)
        for i, p in enumerate(burst_prompts):
            eng.submit(ServeRequest(rid=i, prompt=p, max_new=10))
        out = {r.rid: r.generated for r in eng.run()}
        return out, eng.stats()

    uncapped, st_u = serve_burst(0)
    capped, st_c = serve_burst(4)
    assert capped == uncapped
    print(f"fairness knob: max_prefill_tokens=4 stretches the burst over "
          f"{st_c['ticks']} ticks (vs {st_u['ticks']} uncapped), live "
          f"tokens/dispatch p50 {st_c['tokens_per_dispatch']['p50']:.0f} vs "
          f"{st_u['tokens_per_dispatch']['p50']:.0f} — identical tokens ✓")

    # --- prefix cache: shared system prompt over copy-on-write KV pages ----
    # the first request to finish parks its page-aligned prefix (and a1_sig)
    # in a radix tree; later requests sharing it adopt the pages and
    # prefill only their tail; a write into a shared page copies it first
    sys_prompt = rng.integers(0, cfg.vocab, 40)      # 5 pages at page_size 8
    hot = engine_of(num_pages=64, prefix_cache=True)
    hot.submit(ServeRequest(rid=0, prompt=np.concatenate(
        [sys_prompt, rng.integers(0, cfg.vocab, 4)]), max_new=6))
    hot.run()                    # the cold donor: finishing parks the prefix
    tails = [rng.integers(0, cfg.vocab, 3 + i) for i in range(5)]
    for i, tail in enumerate(tails):
        hot.submit(ServeRequest(rid=1 + i,
                                prompt=np.concatenate([sys_prompt, tail]),
                                max_new=6))
    hot.run()
    stp = hot.stats()["prefix"]
    pg = hot.stats()["pages"]
    print(f"prefix cache: {stp['hits']}/{stp['hits'] + stp['misses']} "
          f"admissions hit ({stp['hit_rate']:.2f}), hit length p50 "
          f"{stp['hit_tokens']['p50']:.0f} tokens; {pg['shares']} "
          f"page-shares vs {pg['allocs']} pages allocated, "
          f"{stp['cow_copies']} COW copies; ttft p50 hot "
          f"{stp['ttft_hit_ticks']['p50']:.0f} ticks vs cold "
          f"{stp['ttft_cold_ticks']['p50']:.0f} ticks")

    # hot tokens are bit-identical to an engine that never shared a page
    ref_eng = engine_of(num_pages=64)
    ref_eng.submit(ServeRequest(rid=1, prompt=np.concatenate(
        [sys_prompt, tails[0]]), max_new=6))
    hit_probe = next(r for r in hot.finished if r.rid == 1)
    assert ref_eng.run()[0].generated == hit_probe.generated
    print("prefix-hit decoding == cold decoding ✓")

    # a request whose WHOLE prompt is cached never prefills: it enters the
    # decode lane on its first tick (its last page COW'd for the first
    # write)
    before = hot.stats()["prefill_tokens"]
    hot.submit(ServeRequest(rid=9, prompt=sys_prompt.copy(), max_new=6))
    hot.run()
    full_hit_prefill = hot.stats()["prefill_tokens"] - before
    print(f"full-prompt hit: {full_hit_prefill} prefill tokens dispatched "
          f"(entered decode on its first tick)")

    # --- quantized KV pages: int8 storage + per-page-row fp32 scales -------
    # one amax / 127 scale per cached token row, shared across KV heads;
    # the kernels dequantize where a row is loaded and accumulate in fp32
    quant = engine_of(kv_dtype="int8")
    for i, p in enumerate(prompts):
        quant.submit(ServeRequest(rid=i, prompt=p, max_new=8 + 3 * (i % 3)))
    quant.run()
    pq, pf = quant.stats()["pages"], engine.stats()["pages"]
    print(f"quantized engine (kv_dtype=int8): {pq['page_bytes']} bytes/page "
          f"vs {pf['page_bytes']} float32 "
          f"({pf['page_bytes']/pq['page_bytes']:.1f}x more requests per "
          f"device byte at equal num_pages); peak KV bytes "
          f"{pq['peak_bytes_in_use']} vs {pf['peak_bytes_in_use']}; "
          f"quantized dispatches trace as "
          f"{[s for s in dispatch_paths() if s.endswith('.int8')]}")

    # --- dual-branch decode: MHA || MLP off the cached FAL signal ----------
    # valid only for fal / parallel connections (ExecutionPlan.validate
    # rejects preln / falplus); on the CPU both engines run the same plain
    # ops and give the same tokens bit for bit; on the card the kernels
    # round differently, so the run reports its rate
    dual = engine_of(dual_branch=True)
    for i, p in enumerate(prompts):
        dual.submit(ServeRequest(rid=i, prompt=p, max_new=8 + 3 * (i % 3)))
    t0 = time.time()
    done_dual = dual.run()
    dt_dual = time.time() - t0
    same = ({r.rid: r.generated for r in done_dual}
            == {r.rid: r.generated for r in done})
    if device.type == "cpu":
        assert same
        print(f"dual-branch engine == sequential tokens ✓ "
              f"({total/dt_dual:.0f} tok/s vs {total/dt:.0f} sequential)")
    else:
        print(f"dual-branch engine: {total/dt_dual:.0f} tok/s vs "
              f"{total/dt:.0f} sequential (the card's kernels; tokens "
              f"{'equal' if same else 'differ'})")
    return {"paths": paths, "batched_eq_lone": ref == probe.generated,
            "capped_eq_uncapped": capped == uncapped,
            "prefix_hits": stp["hits"],
            "cow_copies": hot.stats()["prefix"]["cow_copies"],
            "full_hit_prefill_tokens": full_hit_prefill,
            "page_bytes": {"int8": pq["page_bytes"],
                           "float32": pf["page_bytes"]},
            "dual_eq_sequential": same}


if __name__ == "__main__":
    main()
