#!/usr/bin/env python3
"""Device time of a padded chunk-prefill tick (bf16 pages, llama3.2-3b at
full width, chip_smoke.py's padded generation) with the PyTorch/CUDA port of
the checkout at ROOT, on one CUDA card, as one JSON line.

Run from the root of a checkout:
    python3 experiments/torch_prefill_tick.py ROOT

It uses this checkout's chip_smoke.py helpers (``padded_lanes``,
``padded_prefill``, ``clone_cache``, ``tick_device_time``) with ROOT's port
first on the path, builds ROOT's kernels, runs one unprofiled prefill and
times a second one under torch.profiler.  It checks no kernel by name, so it
times a tree from before the tensor-core chunk route too.  To compare two
trees on one card, run it once a process in the order parent, change,
change, parent.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]


def main():
    if not torch.cuda.is_available():
        print("torch_prefill_tick: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print("usage: python3 experiments/torch_prefill_tick.py ROOT",
              file=sys.stderr)
        return 2
    root = pathlib.Path(sys.argv[1]).resolve()
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"torch_prefill_tick: no port under {root}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    _, smi, _ = cs.device_phase()
    cs.phase(f"prefill tick device time: the port of {root}")
    build.build_all(["paged_attention", "fused_ln_add"])  # before the wall
    cfg = get_config("llama3.2-3b")
    params = M.init_params(cfg, seed=0)
    lens, prompts, bt, cache = cs.padded_lanes(cfg, "", 32)
    empty = cs.clone_cache(cache)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n_pre = cs.padded_prefill(params, cfg, lens, prompts, bt, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n_pre * 1e3
        busy = cs.tick_device_time(
            "prefill", lambda: cs.padded_prefill(params, cfg, lens, prompts,
                                                 bt, empty), wall_ms, n_pre)
    print(json.dumps({"prefill_tick_device_ms": busy, "ticks": n_pre,
                      "root": str(root), "card": smi}))
    return 0 if busy is not None else 1


if __name__ == "__main__":
    sys.exit(main())
