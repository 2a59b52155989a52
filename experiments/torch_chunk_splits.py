#!/usr/bin/env python3
"""Key splits against one split in the port's tensor-core chunk route, timed
on one CUDA card, to set the route's split rule (``kChunkSplitItems`` of
``src/repro_torch/kernels/csrc/paged_packed_tc.cuh``, ``CHUNK_SPLIT_ITEMS`` of
``src/repro_torch/kernels/paged_attention.py``).

Run from the root of a checkout:  python3 experiments/torch_chunk_splits.py

It builds ``paged_attention.cu`` twice from copies of ``csrc/`` under
``build/chunk_splits/`` (one ``nvcc`` each, both at once), with the
threshold set so that every chunk call splits its keys and so that none
does, and times the bf16-q chunk kernel of each through the port's wrapper at
llama3.2-3b attention shapes (H = 24, Hkv = 8, D = 128, page 16, a 2048-key
table): B lanes of C = 128 rows at pos 1800 and at pos 0, on bf16 and int8
pages, with chip_smoke.py's timing (L2 flushed before each launch, a lead,
the median of 50 launches), in the order split, one, one, split.  Both
builds are first held against the plain version within chip_smoke.py's
tolerance.  Prints a line a shape and, last, one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: threshold of each build: "split" splits every call, "one" none
VARIANTS = {"split": 1 << 30, "one": 0}
#: (page type, B, pos) of the timed calls (n_valid = C = 128 on every lane)
SHAPES = ([("", b, 1800) for b in (1, 2, 4, 6, 8, 12, 16)]
          + [("", b, 0) for b in (1, 2, 4, 8)]
          + [("int8", b, 1800) for b in (1, 4, 8)])
C, TB = 128, 128


def build_variants(out_dir):
    """Build the two copies of paged_attention.cu: {variant: library}."""
    from repro_torch.kernels import build
    nvcc, started = build.find_nvcc(), []
    for name, items in VARIANTS.items():
        src = out_dir / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        header = src / "paged_packed_tc.cuh"
        text, n = re.subn(r"kChunkSplitItems = \d+", f"kChunkSplitItems = "
                          f"{items}", header.read_text())
        if n != 1:
            raise RuntimeError("kChunkSplitItems not found once in "
                               "paged_packed_tc.cuh")
        header.write_text(text)
        lib = src / "paged_attention.so"
        started.append((name, lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(lib),
             str(src / "paged_attention.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    libs = {}
    for name, lib, proc in started:
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({name}):\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def use(PA, lib):
    """Route the port's paged-attention wrappers to ``lib``."""
    from repro_torch.kernels import build
    build._LIBS["paged_attention"] = lib
    PA._lib()                                          # sets the argtypes


def main():
    if not torch.cuda.is_available():
        print("torch_chunk_splits: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as PA
    name, smi, bw = cs.device_phase()
    cs.phase("build: paged_attention.cu with every chunk split and with none")
    libs = build_variants(ROOT / "build" / "chunk_splits")
    rows = []
    for kv, B, pos in SHAPES:
        lanes = [(pos, C)] * B
        args, sc = cs.chunk_case(PA, kv, C, lanes, cs.H, cs.HKV, cs.D,
                                 cs.PAGE, TB, seed=B)
        ref = PA.paged_chunk_attention_plain(args[0].float(), *args[1:],
                                             **sc).to(torch.bfloat16)
        row = dict(pages=kv or "bf16", B=B, pos=pos,
                   items=B * -(-C // (64 // (cs.H // cs.HKV))) * cs.HKV,
                   rule=cs.chunk_route(PA, B, C, cs.H, cs.HKV, TB * cs.PAGE))
        for variant in VARIANTS:
            use(PA, libs[variant])
            ws = PA._workspace(PA._lib().paged_chunk_workspace_bytes,
                               args[0], args[1], args[3])
            cs.require((ws is not None) == (variant == "split"),
                       f"the {variant} build sized a workspace of "
                       f"{None if ws is None else ws.numel()} bytes")
            err = cs.max_err(PA.paged_chunk_attention_cuda(*args, **sc), ref)
            cs.require(err <= cs.ATTN_TOLS[torch.bfloat16],
                       f"{variant}: chunk kernel disagrees with plain: {err}")
            row[f"{variant}_err"] = err
        for variant in ("split", "one", "one", "split"):
            use(PA, libs[variant])
            row.setdefault(f"{variant}_ms", []).append(cs._median_ms(
                lambda: PA.paged_chunk_attention_cuda(*args, **sc),
                lead_cycles=cs.LEAD_CYCLES))
        keys = sum(cs.chunk_keys(p, n, C - 1, TB) for p, n in lanes)
        row["bound_ms"] = cs._paged_bound_ms(
            args[0], args[1], keys,
            sum(cs.chunk_keys(p, n, c, TB) for p, n in lanes
                for c in range(C)), args[3].numel() + 2 * B, bw,
            scale_rows=bool(kv))[0]
        rows.append(row)
        print(f"  {row['pages']} pages, B={B} x C={C} at pos {pos} "
              f"({row['items']} row-tile items; the rule: {row['rule']}): "
              f"splits {row['split_ms'][0]:.4f} / {row['split_ms'][1]:.4f} "
              f"ms, one split {row['one_ms'][0]:.4f} / "
              f"{row['one_ms'][1]:.4f} ms, bound {row['bound_ms']:.4f} ms",
              flush=True)
    print(json.dumps({"card": smi, "chunk_splits": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
