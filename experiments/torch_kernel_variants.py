#!/usr/bin/env python3
"""Build constants of two of the port's kernels, timed on one CUDA card:
the ring depth of the key-split decode, timed on one-byte pages
(``kStages`` of ``src/repro_torch/kernels/csrc/paged_decode_splits.cuh``),
the grid and rows a step of the ``fused_ln_add`` backward (``kBwdPerSM``,
``kRowsAStep`` of ``csrc/fused_ln_add.cu``), and the vectors a thread and
the many-row block of its forward (``kFwdVecs``, ``kFwdBlockThreads``).

Run from the root of a checkout:
    python3 experiments/torch_kernel_variants.py decode_stages
    python3 experiments/torch_kernel_variants.py ln_bwd
    python3 experiments/torch_kernel_variants.py ln_fwd

It builds the source once per variant from copies of ``csrc/`` under
``build/variants/<set>/`` (one ``nvcc`` each, all at once), then runs each
variant in a process of its own (two builds of one library in one process
clash: the runtime's per-kernel attributes of the second are not set), in
the order first, ..., last, last, ..., first.  A variant's process holds
its build against the plain version at chip_smoke.py's tolerance and times
it with chip_smoke.py's timing (L2 flushed before each launch, a lead, the
median of 100 launches): decode_stages at chip_smoke.py's decode tick on
int8 and fp8 pages (bf16 q, llama3.2-3b attention, 8 lanes x 1021 keys),
ln_bwd and ln_fwd at chip_smoke.py's timed fused_ln_add shapes (bf16;
the forward without statistics, as a serving tick calls it, also after a
read flush).  Prints a line a variant run and, last, one JSON object.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: set -> (library, patched file, {constant: values})
SETS = {
    "decode_stages": ("paged_attention", "paged_decode_splits.cuh",
                      {"kStages": (3, 4, 5)}),
    "ln_bwd": ("fused_ln_add", "fused_ln_add.cu",
               {"kBwdPerSM": (2, 4), "kRowsAStep": (1, 2)}),
    "ln_fwd": ("fused_ln_add", "fused_ln_add.cu",
               {"kFwdVecs": (2, 4), "kFwdBlockThreads": (256, 512)}),
}


def variants(name):
    """[(tag, {constant: value})] of a set, in order."""
    consts = SETS[name][2]
    out = []
    for values in itertools.product(*consts.values()):
        v = dict(zip(consts, values))
        out.append(("_".join(f"{k}{x}" for k, x in v.items()), v))
    return out


def build_variants(name):
    """Build every variant of a set: {tag: library path}."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    lib_name, patched, _ = SETS[name]
    nvcc, started = build.find_nvcc(), []
    for tag, consts in variants(name):
        src = ROOT / "build" / "variants" / name / tag
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        text = (src / patched).read_text()
        for k, v in consts.items():
            text, n = re.subn(rf"constexpr int {k} = \d+;",
                              f"constexpr int {k} = {v};", text)
            if n != 1:
                raise RuntimeError(f"{k} not found once in {patched}")
        (src / patched).write_text(text)
        lib = src / f"{lib_name}.so"
        started.append((tag, lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(lib),
             str(src / f"{lib_name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    libs = {}
    for tag, lib, proc in started:
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({tag}):\n{log}")
        (lib.parent / "ptxas.log").write_text(log)
        libs[tag] = lib
    return libs


def time_decode(cs, bw):
    from repro_torch.kernels import paged_attention as PA
    out = {}
    for kv in cs.KV_NARROW:
        lens = [1021] * 8
        args, sc = cs.split_case(kv, lens, cs.H, cs.HKV, cs.D, cs.PAGE, 128,
                                 seed=3)
        ref = PA.paged_decode_attention_plain(args[0].float(), *args[1:],
                                              **sc).to(torch.bfloat16)
        err = cs.max_err(PA.paged_decode_attention_cuda(*args, **sc), ref)
        cs.require(err <= cs.ATTN_TOLS[torch.bfloat16],
                   f"decode disagrees with plain: {err}")
        out[kv] = dict(err=err, ms=cs._median_ms(
            lambda: PA.paged_decode_attention_cuda(*args, **sc),
            lead_cycles=cs.LEAD_CYCLES))
    return out


def time_ln_bwd(cs, bw):
    from repro_torch.kernels import fused_ln_add as LN
    out = {}
    for kind, n, d in cs.LN_SHAPES[:cs.LN_TIMED]:
        x, a1, scale, bias, dy = cs.ln_inputs(torch.bfloat16, kind, n, d, 2)
        y, mean, rstd = LN.fused_ln_add_fwd_cuda(x, a1, scale, bias,
                                                 kind=kind)
        xr = x.detach().float().requires_grad_(True)
        ref = LN.ln_add_plain(xr, a1.float(), scale, bias, kind=kind)
        ref.backward(dy.float())
        dx, _, _ = LN.fused_ln_add_bwd_cuda(dy, x, scale, mean, rstd,
                                            kind=kind)
        err = cs.rel_err(dx, xr.grad)
        cs.require(err <= 2e-2, f"backward disagrees with plain: {err}")
        out[f"{kind} ({n}, {d})"] = dict(err=err, ms=cs._median_ms(
            lambda: LN.fused_ln_add_bwd_cuda(dy, x, scale, mean, rstd,
                                             kind=kind),
            lead_cycles=cs.LEAD_CYCLES))
    return out


def time_ln_fwd(cs, bw):
    from repro_torch.kernels import fused_ln_add as LN
    out = {}
    for kind, n, d in cs.LN_SHAPES[:cs.LN_TIMED]:
        x, a1, scale, bias, _ = cs.ln_inputs(torch.bfloat16, kind, n, d, 2)
        ref = LN.ln_add_plain(x, a1, scale, bias, kind=kind)

        def fwd():
            return LN.fused_ln_add_fwd_cuda(x, a1, scale, bias, kind=kind,
                                            stats=False)[0]
        err = cs.max_err(fwd(), ref)
        cs.require(err <= cs.bf16_ulp(ref), f"forward disagrees with plain: "
                   f"{err}")
        out[f"{kind} ({n}, {d})"] = dict(
            err=err, ms=cs._median_ms(fwd, lead_cycles=cs.LEAD_CYCLES),
            clean_ms=cs._median_ms(fwd, lead_cycles=cs.LEAD_CYCLES,
                                   clean=True))
    return out


def child(name, lib_path):
    """Time one variant's library in this process: one JSON line."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    _, smi, bw = cs.device_phase()
    lib_name = SETS[name][0]
    build._LIBS[lib_name] = ctypes.CDLL(str(lib_path))
    timer = {"decode_stages": time_decode, "ln_bwd": time_ln_bwd,
             "ln_fwd": time_ln_fwd}[name]
    print(json.dumps(timer(cs, bw)))
    return 0


def main():
    if len(sys.argv) == 4 and sys.argv[2] == "--child":
        return child(sys.argv[1], sys.argv[3])
    if len(sys.argv) != 2 or sys.argv[1] not in SETS:
        print(f"usage: python3 experiments/torch_kernel_variants.py "
              f"{{{','.join(SETS)}}}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    name = sys.argv[1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"== {name}: {smi}", flush=True)
    libs = build_variants(name)
    tags = [t for t, _ in variants(name)]
    rows = {t: [] for t in tags}
    for tag in tags + tags[::-1]:
        r = subprocess.run([sys.executable, __file__, name, "--child",
                            str(libs[tag])], capture_output=True, text=True,
                           timeout=600)
        lines = r.stdout.strip().splitlines()
        if r.returncode or not lines:
            raise RuntimeError(f"{tag}: exit {r.returncode}\n{r.stdout}\n"
                               f"{r.stderr}")
        rows[tag].append(json.loads(lines[-1]))
        print(f"  {tag}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms (error {v['err']:.2e})"
            for k, v in rows[tag][-1].items()), flush=True)
    print(json.dumps({"card": smi, "set": name, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
