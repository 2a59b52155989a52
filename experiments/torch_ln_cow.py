#!/usr/bin/env python3
"""The LN-add forward, one copy-on-write, and the device time of a packed
engine tick and of a padded bf16 decode tick, with the PyTorch/CUDA port
of the checkout at ROOT, on one CUDA card, as one JSON line.

Run from the root of a checkout:
    python3 experiments/torch_ln_cow.py ROOT

It uses this checkout's chip_smoke.py helpers (``ln_inputs``,
``_median_ms``, ``kernel_breakdown``, ``padded_lanes``, ``padded_prefill``,
``padded_decode``, ``busy_ms``, ``tick_device_time``) with ROOT's port
first on the path, and builds ROOT's kernels.  It gives:

* the LN-add forward at chip_smoke.py's timed shapes (bf16): the call a
  serving tick makes (``fused_ln_add`` under ``torch.no_grad()``), the
  forward wrapper with its statistics, both with a lead after a flush that
  leaves L2 dirty, the latter also after a read flush, and its kernel's
  device time under torch.profiler (inputs warm in L2); beside them the
  time of a one-element ``zero_`` timed the same way (the floor of any
  launch so timed);
* one copy-on-write at llama3.2-3b (one page in all 28 layers; bf16 pages,
  and int8 pages with their scales): ``copy_paged_pages`` with a lead (the
  device interval of the call), without (``wrapper_ms``), and the device
  time of its kernels and copies under torch.profiler;
* the device time of a packed engine tick (llama3.2-3b, 28 layers, bf16;
  chip_smoke.py's engine configuration and its profile workload: 8
  requests of 200 prompt tokens and 24 new, the union of kernel spans a
  tick) and of a padded bf16 decode tick (chip_smoke.py's padded
  generation, sequential plan, 4 ticks profiled after 5).

It checks no kernel by name, so it times a tree from before this redesign
too.  Two builds of one library clash in one process: to compare two trees
on one card, run it once a process in the order parent, change, change,
parent.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
N_TICKS = 4


def ln_forward(cs, LN):
    """{shape: times} of the LN-add forward at the timed shapes."""
    out = {}
    tiny = torch.zeros(1, device="cuda")
    floor = cs._median_ms(lambda: tiny.zero_(), lead_cycles=cs.LEAD_CYCLES)
    print(f"  floor: a one-element zero_ {floor:.4f} ms (lead)")
    for kind, n, d in cs.LN_SHAPES[:cs.LN_TIMED]:
        x, a1, scale, bias, _ = cs.ln_inputs(torch.bfloat16, kind, n, d, 2)

        def served():
            with torch.no_grad():
                return LN.fused_ln_add(x, a1, scale, bias, kind=kind)

        def fwd():
            return LN.fused_ln_add_fwd_cuda(x, a1, scale, bias, kind=kind)

        ref = LN.ln_add_plain(x, a1, scale, bias, kind=kind)
        err = cs.max_err(served(), ref)
        cs.require(err <= cs.bf16_ulp(ref), f"forward disagrees: {err}")
        row = dict(served_ms=cs._median_ms(served,
                                           lead_cycles=cs.LEAD_CYCLES),
                   fwd_ms=cs._median_ms(fwd, lead_cycles=cs.LEAD_CYCLES),
                   fwd_clean_ms=cs._median_ms(fwd, lead_cycles=cs.LEAD_CYCLES,
                                              clean=True),
                   kernel_us=sum(cs.kernel_breakdown(served).values()),
                   floor_ms=floor, err=err)
        out[f"{kind} ({n}, {d})"] = row
        print(f"  fused_ln_add {kind} ({n}, {d}) bf16: served "
              f"{row['served_ms']:.4f} ms, forward with statistics "
              f"{row['fwd_ms']:.4f} (after a read flush "
              f"{row['fwd_clean_ms']:.4f}), kernel {row['kernel_us']:.2f} us "
              f"(profiler, warm L2); error {err:.2e}", flush=True)
    return out


def cow(cs, M, cfg):
    """{page type: times} of one copy-on-write at llama3.2-3b."""
    out = {}
    for kv in ("", "int8"):
        cache = M.init_paged_cache(cfg, 256, cs.PAGE, 8, "bfloat16",
                                   kv_dtype=kv)

        def copy():
            M.copy_paged_pages(cache, [1], [100])

        row = dict(ms=cs._median_ms(copy, lead_cycles=cs.LEAD_CYCLES),
                   wrapper_ms=cs._median_ms(copy),
                   device_us=sum(cs.kernel_breakdown(copy).values()))
        out[kv or "bf16"] = row
        print(f"  one COW, {kv or 'bf16'} pages: {row['ms']:.4f} ms (lead), "
              f"wrapper_ms {row['wrapper_ms']:.4f}, device "
              f"{row['device_us']:.2f} us (profiler)", flush=True)
        del cache
    return out


def engine_tick(cs, cfg, params):
    """Device ms a packed engine tick over the profile workload, and the
    unprofiled wall ms a tick."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.scheduler import (EngineConfig, PagedEngine,
                                             ServeRequest)
    engine = PagedEngine(cfg, params, EngineConfig(
        page_size=16, num_pages=1024, slots=8, prefill_chunk=256,
        max_seq=2048, cache_dtype="bfloat16"))
    rng = np.random.default_rng(0)
    engine.submit(ServeRequest(rid=-1, prompt=rng.integers(0, cfg.vocab, 32),
                               max_new=4))
    engine.run()
    prompts = [rng.integers(0, cfg.vocab, 200) for _ in range(8)]

    def serve():
        engine.finished.clear()
        for i, p in enumerate(prompts):
            engine.submit(ServeRequest(rid=i, prompt=p, max_new=24))
        t0 = engine.ticks
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - w0) * 1e3, engine.ticks - t0

    wall_ms, ticks = serve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve()
    busy = cs.busy_ms(prof) / ticks
    print(f"  packed engine tick: device {busy:.3f} ms/tick (union of "
          f"kernel spans, {ticks} ticks), wall {wall_ms / ticks:.2f} "
          f"ms/tick", flush=True)
    del engine
    torch.cuda.empty_cache()
    return busy, wall_ms / ticks


def decode_tick(cs, cfg, params):
    """Device ms a padded bf16 decode tick (sequential plan)."""
    from repro_torch.core.plan import ExecutionPlan
    seq = ExecutionPlan.single_device("paged")
    lens, prompts, bt, cache = cs.padded_lanes(cfg, "", 32)
    first, _ = cs.padded_prefill(params, cfg, lens, prompts, bt, cache)
    work, prof = cs.clone_cache(cache), cs.clone_cache(cache)
    cs.padded_decode(params, cfg, lens, bt, work, first, seq, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.padded_decode(params, cfg, lens, bt, cache, first, seq, N_TICKS)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / N_TICKS * 1e3
    return cs.tick_device_time("bf16 sequential decode", lambda: (
        cs.padded_decode(params, cfg, lens, bt, prof, first, seq,
                         N_TICKS)), wall_ms, N_TICKS), wall_ms


def main():
    if not torch.cuda.is_available():
        print("torch_ln_cow: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print("usage: python3 experiments/torch_ln_cow.py ROOT",
              file=sys.stderr)
        return 2
    root = pathlib.Path(sys.argv[1]).resolve()
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"torch_ln_cow: no port under {root}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_ln_add as LN
    from repro_torch.models import model as M
    _, smi, _ = cs.device_phase()
    cs.phase(f"LN-add forward, one COW, engine and decode ticks: the port "
             f"of {root}")
    build.build_all(["paged_attention", "fused_ln_add", "page_copy"])
    result = {"root": str(root), "card": smi, "ln_forward": ln_forward(cs, LN)}
    cfg = get_config("llama3.2-3b")
    result["cow"] = cow(cs, M, cfg)
    params = M.init_params(cfg, seed=0)
    with torch.no_grad():
        result["engine_tick_device_ms"], result["engine_tick_wall_ms"] = \
            engine_tick(cs, cfg, params)
        result["decode_tick_device_ms"], result["decode_tick_wall_ms"] = \
            decode_tick(cs, cfg, params)
    print(json.dumps(result))
    return 0 if result["decode_tick_device_ms"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
