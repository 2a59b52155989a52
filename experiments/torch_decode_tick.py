#!/usr/bin/env python3
"""Device time of a quantized padded decode tick (int8 and fp8 pages,
sequential plan, llama3.2-3b at full width and depth, chip_smoke.py's padded
generation) with the PyTorch/CUDA port of the checkout at ROOT, on one CUDA
card, as one JSON line.

Run from the root of a checkout:
    python3 experiments/torch_decode_tick.py ROOT [--alignment]

It uses this checkout's chip_smoke.py helpers (``padded_lanes``,
``padded_prefill``, ``padded_decode``, ``clone_cache``,
``tick_device_time``) with ROOT's port first on the path, builds ROOT's
kernels, prefills each page type's cache, runs one unprofiled decode tick
and 4 counted ones, then times 4 more under torch.profiler.  It checks no
kernel by name, so it times a tree from before the key-split route for
one-byte pages too.  It also prints a digest of ROOT's bf16 decode output
at chip_smoke.py's decode tick (8 lanes x 1021 keys, seeded inputs): two
trees whose bf16 route computes the same bits print the same digest.  With
``--alignment`` it runs chip_smoke.py's ``check_split_alignment`` against
ROOT in child processes (a misaligned read is a sticky CUDA error): the
decode on int8, fp8 and bf16 pages in one, the fused dual route in another,
and reports each child's exit code and last line.  To compare two trees on
one card, run it once a process in the order parent, change, change,
parent.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
N_TICKS = 4


def alignment(root):
    """chip_smoke.py's alignment check against ROOT's port, in children:
    {routes: (exit code, last line)}."""
    out = {}
    for routes in (("int8", "fp8", "bf16"), ("fused",)):
        code = (f"import sys; sys.path[:0] = [{str(root / 'src')!r}, "
                f"{str(HERE)!r}]; import chip_smoke as cs; "
                f"cs.check_split_alignment({routes!r})")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=600)
        lines = (r.stdout + r.stderr).strip().splitlines()
        out[",".join(routes)] = (r.returncode, lines[-1] if lines else "")
        print(f"  alignment check, {'/'.join(routes)}: exit {r.returncode}; "
              + "\n    ".join(lines[-6:]), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_decode_tick: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    check = "--alignment" in args
    args = [a for a in args if a != "--alignment"]
    if len(args) != 1:
        print("usage: python3 experiments/torch_decode_tick.py ROOT "
              "[--alignment]", file=sys.stderr)
        return 2
    root = pathlib.Path(args[0]).resolve()
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"torch_decode_tick: no port under {root}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import model as M
    _, smi, _ = cs.device_phase()
    cs.phase(f"quantized decode tick device time: the port of {root}")
    build.build_all(["paged_attention", "fused_ln_add", "dual_branch"])
    dec = cs.decode_inputs(torch.bfloat16, [1021] * 8, cs.H, cs.HKV, cs.D,
                           cs.PAGE, 128, seed=3)
    out = PA.paged_decode_attention_cuda(*dec)
    digest = hashlib.sha256(
        out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"  bf16 decode output digest (8 lanes x 1021 keys): {digest}")
    result = {"root": str(root), "card": smi, "bf16_decode_digest": digest}
    cfg = get_config("llama3.2-3b")
    params = M.init_params(cfg, seed=0)
    seq = ExecutionPlan.single_device("paged")
    with torch.no_grad():
        for kv in cs.KV_NARROW:
            lens, prompts, bt, cache = cs.padded_lanes(cfg, kv, 32)
            first, _ = cs.padded_prefill(params, cfg, lens, prompts, bt,
                                         cache)
            work, prof = cs.clone_cache(cache), cs.clone_cache(cache)
            cs.padded_decode(params, cfg, lens, bt, work, first, seq, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.padded_decode(params, cfg, lens, bt, cache, first, seq,
                             N_TICKS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / N_TICKS * 1e3
            result[f"{kv}_tick_device_ms"] = cs.tick_device_time(
                f"{kv} sequential", lambda: cs.padded_decode(
                    params, cfg, lens, bt, prof, first, seq, N_TICKS),
                wall_ms, N_TICKS)
            result[f"{kv}_tick_wall_ms"] = wall_ms
            del cache, work, prof
    if check:
        result["alignment"] = alignment(root)
    print(json.dumps(result))
    return 0 if None not in result.values() else 1


if __name__ == "__main__":
    sys.exit(main())
