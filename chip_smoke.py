#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printed on lines of its own; any failure raises and the
script exits non-zero:

  1. device      the card's name and power limit (nvidia-smi); TF32 off
  2. build       every kernel under src/repro_torch/kernels/csrc with nvcc
  3. kernel      each kernel against its plain PyTorch version at the
                 main path's shapes (and small shapes), bf16 and fp32
  4. time        kernel, plain and bound times (median of 100 launches,
                 CUDA events, L2 flushed between launches)
  5. tick        one packed tick of llama3.2-3b at full width (2 layers,
                 fp32) on the card against the plain path on the CPU
  6. engine      24 greedy requests through PagedEngine at full width and
                 depth (llama3.2-3b, 28 layers, bf16), with the kernels'
                 launch counters zeroed just before and read just after
  7. profile     where a tick's time goes: a second, smaller workload on
                 the same engine, timed plainly and under torch.profiler

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout, the script exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 peaks (NVIDIA data sheet; dense bf16 tensor-core rate)
PEAK_BF16_FLOPS = 989e12
SXM_BYTES_PER_S = 3.35e12
PCIE_BYTES_PER_S = 2.0e12

H, HKV, D, PAGE = 24, 8, 128, 16          # llama3.2-3b attention shapes


def phase(name):
    print(f"== {name}", flush=True)


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #
def mixed_tick(*, page, num_pages, tb, n_prefill=256, n_decode=7,
               decode_pos=1024, n_pad=9, seed=0):
    """A packed tick as the engine builds it: one prefill segment at
    positions 0..n_prefill-1 in slot 0, one decode token near
    ``decode_pos`` in each of slots 1..n_decode, then padding rows.
    Returns CPU int32 tensors (block_tables, tok_slot, tok_pos,
    seg_last)."""
    g = torch.Generator().manual_seed(seed)
    slots = n_decode + 1
    perm = (torch.randperm(num_pages - 1, generator=g) + 1).to(torch.int32)
    bt = torch.zeros((slots, tb), dtype=torch.int32)
    used = 0
    last = [n_prefill - 1]
    for s in range(1, slots):
        last.append(decode_pos + int(torch.randint(-8, 8, (1,), generator=g)))
    for s in range(slots):
        n = last[s] // page + 1
        bt[s, :n] = perm[used:used + n]
        used += n
    tok_slot = [0] * n_prefill + list(range(1, slots)) + [0] * n_pad
    tok_pos = list(range(n_prefill)) + last[1:] + [-1] * n_pad
    seg_last = [n_prefill - 1] + [n_prefill + i for i in range(n_decode)]
    as_i32 = lambda v: torch.tensor(v, dtype=torch.int32)   # noqa: E731
    return bt, as_i32(tok_slot), as_i32(tok_pos), as_i32(seg_last)


def decode_tick(*, page, num_pages, tb, n=8, pos=1020, seed=1):
    """n decode tokens, one per slot, each over about pos/page pages."""
    g = torch.Generator().manual_seed(seed)
    perm = (torch.randperm(num_pages - 1, generator=g) + 1).to(torch.int32)
    need = pos // page + 1
    bt = torch.zeros((n, tb), dtype=torch.int32)
    for s in range(n):
        bt[s, :need] = perm[s * need:(s + 1) * need]
    return (bt, torch.arange(n, dtype=torch.int32),
            torch.full((n,), pos, dtype=torch.int32))


def attention_inputs(dtype, T, h, hkv, d, page, num_pages, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731,E501
    return (rnd(T, h, d), rnd(num_pages, page, hkv, d),
            rnd(num_pages, page, hkv, d))


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def device_phase():
    phase("device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch.cuda.get_device_name: {name}; device_count "
          f"{torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bw = PCIE_BYTES_PER_S if "PCIe" in name else SXM_BYTES_PER_S
    return name, smi, bw


def build_phase():
    from repro_torch.kernels import build
    phase("build")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, log in build.PTXAS_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    sys.stdout.flush()


def check_kernel(PA, dtype, tick, h, hkv, d, page, num_pages, tol,
                 seed):
    """Kernel vs its plain version on the same inputs (the plain version
    computed in fp32 from them, then rounded to ``dtype``).  Returns the
    max abs error over live rows; padding rows must be exactly 0."""
    bt, tok_slot, tok_pos = (x.cuda() for x in tick[:3])
    q, kp, vp = attention_inputs(dtype, tok_slot.numel(), h, hkv, d,
                                 page, num_pages, seed)
    out = PA.paged_packed_attention_cuda(q, kp, vp, bt, tok_slot, tok_pos)
    ref = PA.paged_packed_attention_plain(q.float(), kp.float(), vp.float(),
                                          bt, tok_slot, tok_pos).to(dtype)
    torch.cuda.synchronize()
    live = tok_pos >= 0
    err = (out[live].float() - ref[live].float()).abs().max().item()
    pad = out[~live].abs().max().item() if (~live).any() else 0.0
    print(f"  {str(dtype):15s} H={h} Hkv={hkv} D={d} page={page} "
          f"T={tok_slot.numel()}: max_abs_err {err:.3e} (tol {tol:g}), "
          f"padding max {pad}", flush=True)
    if not err <= tol:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{err} > {tol}")
    if pad != 0.0:
        raise AssertionError("padding rows are not exactly 0")
    return err


def kernel_phase():
    from repro_torch.kernels import paged_attention as PA
    phase("kernel vs plain")
    # fp32: both sides accumulate in fp32 in another order, so they agree
    # to a few ulp of values of order 1 -> 1e-4
    # bf16: both compute in fp32 and round the output to bf16 once; the
    # fp32 values agree to ~1e-6, so outputs differ by at most one bf16 ulp
    # (2^-7 = 0.0078 for |o| < 2, 0.0156 below 4) -> 2e-2
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    num_pages, tb = 1024, 128
    tick = mixed_tick(page=PAGE, num_pages=num_pages, tb=tb)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs[dtype] = check_kernel(PA, dtype, tick, H, HKV, D, PAGE,
                                   num_pages, tols[dtype], seed=10)
    for d, page, h, hkv in ((64, 16, 6, 2), (32, 16, 8, 2), (128, 4, 12, 4),
                            (128, 8, 4, 4), (64, 4, 16, 2), (32, 8, 3, 1)):
        small = mixed_tick(page=page, num_pages=256, tb=96 // page * 4,
                           n_prefill=37, n_decode=3, decode_pos=90, n_pad=3,
                           seed=d + page)
        for dtype in (torch.bfloat16, torch.float32):
            check_kernel(PA, dtype, small, h, hkv, d, page, 256,
                         tols[dtype], seed=d * page)
    return errs[torch.bfloat16]


def _median_ms(fn, n=100, flush_bytes=256 << 20):
    """Median over n launches of one launch's CUDA-event time, with the L2
    cache flushed before each launch (the engine finds pages cold: every
    other layer's pages pass through L2 between two reads of a layer)."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()                                                   # warm-up
    times = []
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(q, kp, bt, tok_slot, tok_pos, bw):
    """Least time for the work: max(bytes / bandwidth, flops / peak).
    Bytes: every slot's key rows up to its furthest token, K and V, read
    once, plus q, the output and the index arrays; flops: 4 * H * D per
    (token, visible key)."""
    T, h, d = q.shape
    hkv = kp.shape[2]
    live = tok_pos >= 0
    row = 2 * hkv * d * kp.element_size()
    furthest = {}
    for s, p in zip(tok_slot[live].tolist(), tok_pos[live].tolist()):
        furthest[s] = max(furthest.get(s, -1), p)
    kv_bytes = sum(p + 1 for p in furthest.values()) * row
    io_bytes = 2 * q.numel() * q.element_size() + 4 * (
        bt.numel() + 2 * tok_slot.numel())
    flops = 4 * h * d * int((tok_pos[live].long() + 1).sum())
    t_bytes = (kv_bytes + io_bytes) / bw
    t_ops = flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_phase(bw):
    from repro_torch.kernels import paged_attention as PA
    phase("kernel time")
    num_pages, tb = 1024, 128
    rows = {}
    for label, tick in (
            ("decode tick (8 tokens x ~64 pages)",
             decode_tick(page=PAGE, num_pages=num_pages, tb=tb)),
            ("mixed tick (256 prefill + 7 decode near 1024 + 9 pad)",
             mixed_tick(page=PAGE, num_pages=num_pages, tb=tb))):
        bt, tok_slot, tok_pos = (x.cuda() for x in tick[:3])
        q, kp, vp = attention_inputs(torch.bfloat16, tok_slot.numel(),
                                     H, HKV, D, PAGE, num_pages, seed=3)
        kernel_ms = _median_ms(lambda: PA.paged_packed_attention_cuda(
            q, kp, vp, bt, tok_slot, tok_pos))
        plain_ms = _median_ms(lambda: PA.paged_packed_attention_plain(
            q, kp, vp, bt, tok_slot, tok_pos))
        bound_ms, bound_by = _bound_ms(q, kp, bt, tok_slot, tok_pos,
                                       bw)
        rows[label] = dict(ms=kernel_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        print(f"  {label}: kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) "
              f"library_ms none (no single PyTorch call computes paged "
              f"ragged attention)", flush=True)
    return rows


def tick_phase():
    from repro_torch import interop
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    phase("one packed tick at full width: card (kernel) vs CPU (plain)")
    cfg = get_config("llama3.2-3b").replace(n_layers=2, dtype="float32")
    num_pages, tb = 512, 72
    bt, tok_slot, tok_pos, seg_last = mixed_tick(
        page=PAGE, num_pages=num_pages, tb=tb, seed=5)
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, tok_slot.shape, generator=g,
                           dtype=torch.int32)
    batch = dict(tokens=tokens, tok_slot=tok_slot, tok_pos=tok_pos,
                 block_tables=bt, seg_last=seg_last)
    params = M.init_params(cfg, seed=0, device="cpu")
    cache = M.init_paged_cache(cfg, num_pages, PAGE, seg_last.numel(),
                               "float32", device="cpu")
    for pools in (cache["block0"], cache["blocks"]):    # the history
        for name in ("k", "v"):
            pools[name].copy_(torch.randn(pools[name].shape, generator=g))
    cache["a1_sig"].copy_(torch.randn(cache["a1_sig"].shape, generator=g))
    gpu = {k: interop.tree_to(v, "cuda") for k, v in
           (("params", params), ("cache", cache), ("batch", batch))}
    ops.reset_dispatch_paths()
    with torch.no_grad():
        h_gpu, c_gpu = M.paged_decode_step(gpu["params"], cfg, gpu["batch"],
                                           gpu["cache"], want="hidden")
        torch.cuda.synchronize()
        paths_gpu = ops.dispatch_paths()
        h_cpu, c_cpu = M.paged_decode_step(params, cfg, batch, cache,
                                           want="hidden")
    live = tok_pos >= 0
    dh = (h_gpu[0, live.cuda()].cpu() - h_cpu[0, live]).abs().max().item()
    ds = (c_gpu["a1_sig"].cpu() - c_cpu["a1_sig"]).abs().max().item()
    scale = h_cpu[0, live].abs().max().item()
    print(f"  hidden max |diff| {dh:.3e} (max |h| {scale:.3f}); a1_sig max "
          f"|diff| {ds:.3e}; tol 1e-3 (fp32 on both sides, sums in another "
          f"order, activations of order 1); card path {paths_gpu}",
          flush=True)
    if paths_gpu != {"paged_packed_attention": ops.CUDA}:
        raise AssertionError(f"card tick did not run the kernel: {paths_gpu}")
    if not (dh <= 1e-3 and ds <= 1e-3):
        raise AssertionError("card tick disagrees with the CPU plain path")
    if not torch.isfinite(h_gpu).all():
        raise AssertionError("non-finite hidden states on the card")


def engine_phase():
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops, paged_attention as PA
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import (EngineConfig, PagedEngine,
                                             ServeRequest)
    phase("engine: llama3.2-3b, 28 layers, bf16, 24 greedy requests")
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"  init_params on the card: {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(page_size=16, num_pages=1024, slots=8,
                        prefill_chunk=256, max_seq=2048,
                        cache_dtype="bfloat16")
    engine = PagedEngine(cfg, params, ecfg)
    nan_seen = []
    inner = engine.step_fn

    def checked(*args):
        logits, nxt, cache = inner(*args)
        nan_seen.append(torch.isnan(logits).any())
        return logits, nxt, cache

    engine.step_fn = checked
    rng = np.random.default_rng(0)
    # warm-up request: cuBLAS handles and allocator pools, outside the count
    engine.submit(ServeRequest(rid=-1, prompt=rng.integers(0, cfg.vocab, 32),
                               max_new=4))
    engine.run()
    engine.finished.clear()
    nan_seen.clear()
    engine.reset_stats()
    lens = rng.integers(64, 1025, 24)
    reqs = [ServeRequest(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)),
                         max_new=64) for i, n in enumerate(lens)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    PA.reset_launches()
    ops.reset_dispatch_paths()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.LAUNCHES
    paths = ops.dispatch_paths()
    st = engine.stats()
    gen = sum(len(r.generated) for r in done)
    print(f"  prompts {int(lens.min())}..{int(lens.max())} tokens "
          f"(sum {int(lens.sum())}), max_new 64")
    print(f"  ticks {st['ticks']} packed_calls {st['packed_calls']} "
          f"tokens generated {gen} in {wall:.2f} s = {gen / wall:.1f} tok/s; "
          f"engine_dispatch_ms p50 {st['dispatch_ms']['p50']:.2f} p99 "
          f"{st['dispatch_ms']['p99']:.2f}; ttft_ms p50 "
          f"{st['ttft_ms']['p50']:.1f}; peak pages "
          f"{st['pages']['peak_in_use']}/{st['pages']['capacity']}; "
          f"preemptions {st['preemptions']}")
    print(f"  paged_packed_attention launches {launches} (ticks x layers = "
          f"{st['ticks']} x {cfg.n_layers} = {st['ticks'] * cfg.n_layers}); "
          f"dispatch paths {paths}", flush=True)
    if len(done) != len(reqs) or any(
            r.truncated or len(r.generated) != 64 for r in done):
        raise AssertionError("not every request finished with 64 tokens")
    if bool(torch.stack(nan_seen).any()):
        raise AssertionError("NaN logits")
    if launches != st["ticks"] * cfg.n_layers \
            or st["packed_calls"] != st["ticks"]:
        raise AssertionError("kernel launches != ticks x layers")
    if paths != {"paged_packed_attention": ops.CUDA}:
        raise AssertionError(f"engine did not run the kernel only: {paths}")
    profile_phase(engine, cfg, rng)
    return launches, dict(ticks=st["ticks"], tok_s=gen / wall, wall_s=wall)


def profile_phase(engine, cfg, rng):
    """Where a tick's time goes, after the counted run: the same second
    workload (8 requests of 200 prompt tokens, 24 new tokens each) is served
    twice by the same engine, first plainly for the wall time, then under
    torch.profiler for the device time (the sum of the CUDA kernels' own
    times).  Busy share = device time / unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.scheduler import ServeRequest
    phase("profile: 8 requests x (200 prompt + 24 new), torch.profiler")
    prompts = [rng.integers(0, cfg.vocab, 200) for _ in range(8)]

    def serve():
        for i, p in enumerate(prompts):
            engine.submit(ServeRequest(rid=100 + i, prompt=p, max_new=24))
        t0 = engine.ticks
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - w0) * 1e3, engine.ticks - t0

    wall_ms, ticks = serve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_ms, prof_ticks = serve()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(ms for _, ms, _ in rows)
    attn_ms = sum(ms for k, ms, _ in rows if "paged_packed_kernel" in k)
    print(f"  unprofiled: {ticks} ticks in {wall_ms:.1f} ms "
          f"({wall_ms / ticks:.2f} ms/tick); profiled: {prof_ticks} ticks in "
          f"{prof_wall_ms:.1f} ms")
    if device_ms == 0.0 or prof_ticks != ticks:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels, or the two runs differ)")
        return
    busy = device_ms / wall_ms
    print(f"  device kernel time {device_ms:.1f} ms ({device_ms / ticks:.2f} "
          f"ms/tick): busy share {busy:.3f}, idle share {1 - busy:.3f} of "
          f"the unprofiled wall; paged_packed_attention {attn_ms:.2f} ms = "
          f"{attn_ms / device_ms:.3f} of device time")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    {ms:9.2f} ms {n:6d} calls  {key[:90]}")
    sys.stdout.flush()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    name, smi, bw = device_phase()
    build_phase()
    err = kernel_phase()
    times = time_phase(bw)
    tick_phase()
    launches, eng = engine_phase()
    main_shape = "mixed tick (256 prefill + 7 decode near 1024 + 9 pad)"
    row = times[main_shape]
    kernels = [{
        "name": "paged_packed_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:346",
        "launches": launches,
        "max_abs_err": err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "shape": main_shape + ", bf16, H=24 Hkv=8 D=128 page=16",
    }]
    print(f"total {time.perf_counter() - t_start:.1f} s; engine "
          f"{eng['tok_s']:.1f} tok/s over {eng['ticks']} ticks; card {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
