#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printed on lines of its own; any failure raises and the
script exits non-zero:

  1. device      the card's name and power limit (nvidia-smi); TF32 off
  2. build       every kernel under src/repro_torch/kernels/csrc with nvcc,
                 one nvcc per source, all started together
  3. kernel      each kernel against its plain PyTorch version at the
                 main path's shapes (and small shapes), bf16 and fp32; the
                 dual-branch dispatcher's two-op route
  4. time        kernel, plain and bound times (median of 100 launches,
                 CUDA events, L2 flushed between launches)
  5. tick        one packed tick, one padded C = 128 chunk tick and one
                 dual-branch C == 1 tick of llama3.2-3b at full width (2
                 layers, fp32) on the card against the plain path on the CPU
  6. engine      24 greedy requests through PagedEngine at full width and
                 depth (llama3.2-3b, 28 layers, bf16), with the kernels'
                 launch counters zeroed just before and read just after
  7. profile     where a tick's time goes: a second, smaller workload on
                 the same engine, timed plainly and under torch.profiler
  8. dual engine the profile workload again through
                 EngineConfig(dual_branch=True): the same token streams
  9. padded      padded (B, C) generation at full width and depth: chunk
                 prefill ticks, then 32 greedy C == 1 ticks sequentially and
                 again under the dual-branch plan from the same cache

Every main-path run (6, 8 and each run of 9) zeroes all launch counters
just before it and reads them just after.  The line before the last is a
JSON object with one entry per kernel; the last line is {"ok": true,
"device": {...}}.  Without a CUDA device, or outside a checkout, the script
exits non-zero and prints no result.  It imports nothing of JAX and nothing
of the JAX package ``repro``.
"""
import json
import math
import pathlib
import re
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

#: bound on |logit| differences between sequential and dual-branch decode
#: at llama3.2-3b in bf16 (padded generation phase).  Attention is the same
#: kernel code on both routes; the FFN differs: the fused kernel keeps x @ wg,
#: x @ wi and the activation in fp32 and rounds y once, where mlp_apply rounds
#: each of them to bf16 (relative 2^-9 each).  Those differences enter the
#: residual stream in each of 27 blocks and reach logits of order 1 through
#: the final norm.
DUAL_LOGIT_BOUND = 0.25


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


def lane_tables(lens, *, page, tb, seed):
    """Padded-layout block tables: lane b owns ceil(lens[b] / page) distinct
    random pages (at most tb), the rest of its row is the scratch page 0.
    Returns (CPU int32 (B, tb) tables, the pool size in pages)."""
    need = [min(-(-int(n) // page), tb) for n in lens]
    num_pages = sum(need) + 1
    g = torch.Generator().manual_seed(seed)
    perm = (torch.randperm(num_pages - 1, generator=g) + 1).to(torch.int32)
    bt = torch.zeros((len(lens), tb), dtype=torch.int32)
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[used:used + n]
        used += n
    return bt, num_pages


def cuda_i32(v):
    return torch.tensor(v, dtype=torch.int32, device="cuda")


def randn(g, dtype, *shape, std=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)


def decode_inputs(dtype, seq_lens, h, hkv, d, page, tb, seed):
    """(q, k_pages, v_pages, block_tables, seq_lens) on the card."""
    bt, num_pages = lane_tables(seq_lens, page=page, tb=tb, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (randn(g, dtype, len(seq_lens), h, d),
            randn(g, dtype, num_pages, page, hkv, d),
            randn(g, dtype, num_pages, page, hkv, d), bt.cuda(),
            cuda_i32(seq_lens))


def chunk_inputs(dtype, C, lanes, h, hkv, d, page, tb, seed):
    """(q, k_pages, v_pages, block_tables, pos, n_valid) on the card for
    ``lanes`` = [(pos, n_valid)]; each lane owns pages up to pos + C."""
    bt, num_pages = lane_tables([p + C for p, _ in lanes], page=page, tb=tb,
                                seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (randn(g, dtype, len(lanes), C, h, d),
            randn(g, dtype, num_pages, page, hkv, d),
            randn(g, dtype, num_pages, page, hkv, d), bt.cuda(),
            cuda_i32([p for p, _ in lanes]), cuda_i32([n for _, n in lanes]))


def ffn_inputs(g, dtype, kind, B, dm, f):
    """x (B, dm) and dense-MLP weights at ``layers.dense_init``'s scales."""
    ffn = {"wi": randn(g, dtype, dm, f, std=dm ** -0.5),
           "wo": randn(g, dtype, f, dm, std=f ** -0.5)}
    if kind != "gelu":
        ffn["wg"] = randn(g, dtype, dm, f, std=dm ** -0.5)
    return randn(g, dtype, B, dm), ffn


def fused_inputs(dtype, kind, B, f, *, dm=3072, h=H, hkv=HKV, d=D,
                 page=PAGE, tb=128, seq=1021, seed=0):
    """Attention inputs of ``decode_inputs`` at ragged lengths up to
    ``seq`` (one lane at 1) and an FFN (x, weights) for the fused kernel."""
    seq_lens = [1] + [max(1, seq - seq // B * b) for b in range(B - 1)]
    att = decode_inputs(dtype, seq_lens, h, hkv, d, page, tb, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return att + ffn_inputs(g, dtype, kind, B, dm, f)


def max_err(out, ref):
    return (out.float() - ref.float()).abs().max().item()


def bf16_ulp(ref):
    """One bfloat16 ulp at the largest magnitude of ``ref``: 2^(e - 7) for
    |ref| in [2^e, 2^(e+1))."""
    top = max(ref.float().abs().max().item(), 2.0 ** -126)
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def require(ok, msg):
    if not ok:
        raise AssertionError(msg)


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
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spill = [int(m) for m in re.findall(r"(\d+) bytes spill", log)]
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)]
        print(f"  {name}: {len(regs)} kernels, {min(regs)}..{max(regs)} "
              f"registers, at most {max(smem)} bytes static shared memory, "
              f"{sum(spill)} bytes spilled (ptxas -v)")
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


#: (D, page, H, Hkv) small shapes: G = 3, 4, 3, 1, 8, 3, 2
SMALL_SHAPES = ((64, 16, 6, 2), (32, 16, 8, 2), (128, 4, 12, 4),
                (128, 8, 4, 4), (64, 4, 16, 2), (32, 8, 3, 1), (32, 4, 4, 2))
#: the tolerances of the packed kernel, for the same attention block
ATTN_TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: C = 128 and C = 1 chunks at the main shape (table width 128):
#: [(pos, n_valid)] with n_valid 0, 1, < C and C, at pos 0 and > 0
MAIN_CHUNKS = ((128, ((0, 128), (0, 0), (0, 1), (0, 57), (256, 128),
                      (256, 0), (384, 1), (1000, 77))),
               (1, ((0, 0), (0, 1), (5, 0), (5, 1), (PAGE - 1, 1),
                    (PAGE, 1), (1000, 1), (128 * PAGE - 1, 1))))


def report(label, err, tol):
    print(f"  {label}: max_abs_err {err:.3e} (tol {tol:.3g})", flush=True)
    require(err <= tol, f"{label}: kernel disagrees with its plain version: "
            f"{err} > {tol}")
    return err


def padded_kernel_phase():
    """The decode and chunk kernels against their plain versions on every
    row (decode lanes have seq_len >= 1, where ref.py and the kernels
    agree).  Returns the main shape's bf16 error per kernel."""
    from repro_torch.kernels import paged_attention as PA
    phase("kernel vs plain: paged_decode_attention, paged_chunk_attention")
    tb = 128
    dec = [(H, HKV, D, PAGE, tb, [1, PAGE, tb * PAGE, 1021, 500, 2 * PAGE,
                                  1020, 777])]
    chk = [(H, HKV, D, PAGE, tb, c, lanes) for c, lanes in MAIN_CHUNKS]
    for d, page, h, hkv in SMALL_SHAPES:
        dec.append((h, hkv, d, page, 12, [1, page, 12 * page, 3 * page + 1,
                                          5]))
        for c in (8, 1):
            chk.append((h, hkv, d, page, 12, c,
                        ((0, c), (0, 0), (3, 1), (5, max(c - 3, 0)),
                         (9, 0), (2, c))))
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = ATTN_TOLS[dtype]
        for i, (h, hkv, d, page, tbl, lens) in enumerate(dec):
            args = decode_inputs(dtype, lens, h, hkv, d, page, tbl, seed=i)
            out = PA.paged_decode_attention_cuda(*args)
            ref = PA.paged_decode_attention_plain(
                *(a.float() for a in args[:3]), *args[3:]).to(dtype)
            torch.cuda.synchronize()
            err = report(f"decode {str(dtype):14s} H={h} Hkv={hkv} D={d} "
                         f"page={page} Tb={tbl} seq_lens={lens}",
                         max_err(out, ref), tol)
            if i == 0 and dtype == torch.bfloat16:
                errs["paged_decode_attention"] = err
        for i, (h, hkv, d, page, tbl, c, lanes) in enumerate(chk):
            args = chunk_inputs(dtype, c, lanes, h, hkv, d, page, tbl,
                                seed=100 + i)
            out = PA.paged_chunk_attention_cuda(*args)
            ref = PA.paged_chunk_attention_plain(
                *(a.float() for a in args[:3]), *args[3:]).to(dtype)
            torch.cuda.synchronize()
            # rows with nothing visible (n_valid 0 at pos 0) are exact 0
            dead = (args[4] + args[5] == 0)
            require(not dead.any() or out[dead].abs().max().item() == 0.0,
                    "chunk rows with no visible key are not 0")
            err = report(f"chunk  {str(dtype):14s} H={h} Hkv={hkv} D={d} "
                         f"page={page} C={c} (pos, n_valid)={list(lanes)}, "
                         f"all rows", max_err(out, ref), tol)
            if i == 0 and dtype == torch.bfloat16:
                errs["paged_chunk_attention"] = err
    return errs


def fused_kernel_phase():
    """The fused kernel against its plain version (the plain decode
    attention, then ``mlp_apply``, computed in fp32 from the same inputs),
    and the dispatcher's two routes.  Returns the main shape's bf16
    error."""
    from repro_torch.kernels import dual_branch as DB
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    phase("kernel vs plain: fused_dual_branch_decode")
    # attn: the decode kernel's attention block -> ATTN_TOLS.
    # y in fp32: both sides sum Dm and F products of order-1 values in fp32
    # in another order (tiles of 64, then tile partials) -> 1e-4.
    # y in bf16: kernel and plain version both compute in fp32 from the same
    # bf16 inputs and round once, so they differ by at most one bf16 ulp at
    # the largest |y|.
    cases = [(kind, B, f, dict()) for kind in DB.KINDS for B in (3, 8)
             for f in (8192, 8192 + 40)]             # + 40: a ragged tile
    cases += [("swiglu", 2, 256, dict(dm=64, h=8, hkv=2, d=32, page=8, tb=4,
                                      seq=29)),
              ("gelu", 5, 98, dict(dm=100, h=6, hkv=2, d=64, page=4, tb=6,
                                   seq=23)),          # element loads
              ("geglu", 11, 200, dict(dm=136, h=4, hkv=4, d=128, page=16,
                                      tb=3, seq=40))]  # two row groups
    err_main = None
    for dtype in (torch.bfloat16, torch.float32):
        for i, (kind, B, f, kw) in enumerate(cases):
            q, kp, vp, bt, sl, x, ffn = fused_inputs(dtype, kind, B, f,
                                                     seed=200 + i, **kw)
            attn, y = DB.fused_dual_branch_decode_cuda(q, kp, vp, bt, sl, x,
                                                       ffn, kind=kind)
            ra, ry = DB.fused_dual_branch_decode_plain(
                q.float(), kp.float(), vp.float(), bt, sl, x.float(),
                {k: w.float() for k, w in ffn.items()}, kind=kind)
            torch.cuda.synchronize()
            ry = ry.to(dtype)
            tol_y = 1e-4 if dtype == torch.float32 else bf16_ulp(ry)
            shape = (f"{str(dtype):14s} {kind} B={B} F={f} "
                     f"Dm={x.shape[1]} H={q.shape[1]} Hkv={kp.shape[2]} "
                     f"D={q.shape[2]}")
            e_a = report(f"fused attn {shape}", max_err(attn, ra.to(dtype)),
                         ATTN_TOLS[dtype])
            e_y = report(f"fused ffn  {shape}", max_err(y, ry), tol_y)
            if dtype == torch.bfloat16 and (kind, B, f) == ("swiglu", 8,
                                                            8192):
                err_main = max(e_a, e_y)
    # the dispatcher: F % (Hkv * Tb) == 0 fuses; otherwise the decode kernel
    # and mlp_apply (Hkv * Tb = 1024 here).  The two-op route's FFN is the
    # one mlp_apply call, so it equals a second call on the same inputs.
    for f, fused in ((8192, True), (8192 + 64, False)):
        q, kp, vp, bt, sl, x, ffn = fused_inputs(torch.bfloat16, "swiglu", 8,
                                                 f, seed=300)
        ops.reset_launches()
        attn, y = ops.dual_branch_decode(q, kp, vp, bt, sl, x[:, None], ffn,
                                         kind="swiglu")
        counts = ops.launch_counts()
        ra, ry = DB.fused_dual_branch_decode_plain(
            q.float(), kp.float(), vp.float(), bt, sl, x.float(),
            {k: w.float() for k, w in ffn.items()})
        ry = ry.to(x.dtype) if fused else L.mlp_apply(ffn, x[:, None])[:, 0]
        torch.cuda.synchronize()
        print(f"  dispatcher F={f}: launches {counts}")
        require(counts["fused_dual_branch_decode"] == int(fused)
                and counts["paged_decode_attention"] == int(not fused),
                f"dual_branch_decode took the wrong route: {counts}")
        report(f"dispatcher F={f} attn", max_err(attn, ra.to(q.dtype)),
               ATTN_TOLS[torch.bfloat16])
        report(f"dispatcher F={f} ffn", max_err(y[:, 0], ry),
               bf16_ulp(ry) if fused else 0.0)
    return err_main


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


def _paged_bound_ms(q, kp, kv_rows, score_keys, index_numel, bw, *,
                    extra_bytes=0, extra_flops=0):
    """Least time for the work: max(bytes / bandwidth, flops / peak).
    Bytes: ``kv_rows`` K and V rows (Hkv * D each) read once, q read and
    the output written once, the int32 index arrays, plus ``extra_bytes``;
    flops: 4 * H * D per (query row, visible key), plus ``extra_flops``."""
    h, d = q.shape[-2:]
    row = 2 * kp.shape[2] * d * kp.element_size()
    nbytes = (kv_rows * row + 2 * q.numel() * q.element_size()
              + 4 * index_numel + extra_bytes)
    t_bytes = nbytes / bw
    t_ops = (4 * h * d * score_keys + extra_flops) / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bound_ms(q, kp, bt, tok_slot, tok_pos, bw):
    """The packed kernel's bound: every slot's key rows up to its furthest
    token, and each token's visible keys."""
    live = tok_pos >= 0
    furthest = {}
    for s, p in zip(tok_slot[live].tolist(), tok_pos[live].tolist()):
        furthest[s] = max(furthest.get(s, -1), p)
    return _paged_bound_ms(q, kp, sum(p + 1 for p in furthest.values()),
                           int((tok_pos[live].long() + 1).sum()),
                           bt.numel() + 2 * tok_slot.numel(), bw)


def chunk_keys(pos, n_valid, c, tb):
    """Keys visible to chunk row c of a lane at (pos, n_valid)."""
    return max(0, min(min(pos + c, pos + n_valid - 1) + 1, tb * PAGE))


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


def padded_time_phase(bw):
    """Kernel, plain and bound times of the decode, chunk and fused kernels
    at their main-path shapes (bf16, llama3.2-3b attention, table width
    128); the fused kernel also beside its two-op route (decode kernel +
    ``mlp_apply`` on cuBLAS)."""
    from repro_torch.kernels import dual_branch as DB
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import layers as L
    phase("kernel time: decode, chunk, fused dual-branch")
    bf16, tb, rows = torch.bfloat16, 128, {}
    lens = [1021] * 8
    keys = sum(lens)
    dec = decode_inputs(bf16, lens, H, HKV, D, PAGE, tb, seed=3)
    lanes = [(256, n) for n in (128, 128, 44, 128, 100, 128, 0, 128)]
    chk = chunk_inputs(bf16, 128, lanes, H, HKV, D, PAGE, tb, seed=4)
    g = torch.Generator(device="cuda").manual_seed(6)
    x, ffn = ffn_inputs(g, bf16, "swiglu", 8, 3072, 8192)
    w_numel = sum(w.numel() for w in ffn.values())
    cases = {
        "paged_decode_attention": (
            "decode tick: 8 lanes x 1021 keys",
            lambda: PA.paged_decode_attention_cuda(*dec),
            lambda: PA.paged_decode_attention_plain(*dec),
            _paged_bound_ms(dec[0], dec[1], keys, keys,
                            dec[3].numel() + 8, bw)),
        "paged_chunk_attention": (
            f"chunk tick: 8 lanes x C=128 at pos 256, n_valid "
            f"{[n for _, n in lanes]}",
            lambda: PA.paged_chunk_attention_cuda(*chk),
            lambda: PA.paged_chunk_attention_plain(*chk),
            _paged_bound_ms(
                chk[0], chk[1],
                sum(chunk_keys(p, n, 127, tb) for p, n in lanes),
                sum(chunk_keys(p, n, c, tb) for p, n in lanes
                    for c in range(128)), chk[3].numel() + 16, bw)),
        "fused_dual_branch_decode": (
            "dual decode tick: 8 lanes x 1021 keys || swiglu FFN Dm=3072 "
            "F=8192",
            lambda: DB.fused_dual_branch_decode_cuda(*dec, x, ffn),
            lambda: DB.fused_dual_branch_decode_plain(*dec, x, ffn),
            _paged_bound_ms(dec[0], dec[1], keys, keys,
                            dec[3].numel() + 8, bw,
                            extra_bytes=2 * (w_numel + 2 * x.numel()),
                            extra_flops=2 * 8 * w_numel)),
    }
    for name, (shape, kernel, plain, (bound_ms, bound_by)) in cases.items():
        row = dict(shape=shape + ", bf16, H=24 Hkv=8 D=128 page=16 Tb=128",
                   ms=_median_ms(kernel), plain_ms=_median_ms(plain),
                   bound_ms=bound_ms, bound_by=bound_by)
        extra = ""
        if name == "fused_dual_branch_decode":
            row["unfused_ms"] = _median_ms(lambda: (
                PA.paged_decode_attention_cuda(*dec),
                L.mlp_apply(ffn, x[:, None], "swiglu")))
            # where its time goes: the same call with one key per lane
            short = (*dec[:4], torch.ones_like(dec[4]))
            ffn_ms = _median_ms(lambda: DB.fused_dual_branch_decode_cuda(
                *short, x, ffn))
            extra = (f" unfused_ms {row['unfused_ms']:.4f} (decode kernel + "
                     f"mlp_apply); with 1 key per lane (FFN blocks alone) "
                     f"{ffn_ms:.4f}")
        rows[name] = row
        print(f"  {name}, {row['shape']}: kernel_ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} bound_ms {bound_ms:.4f} "
              f"({bound_by}){extra} library_ms none (no single PyTorch call "
              f"computes it)", flush=True)
    return rows


def random_history(cache, g):
    """Fill every K/V pool and the per-slot a1_sig with N(0, 1)."""
    for pools in (cache["block0"], cache["blocks"]):
        for name in ("k", "v"):
            pools[name].copy_(torch.randn(pools[name].shape, generator=g))
    cache["a1_sig"].copy_(torch.randn(cache["a1_sig"].shape, generator=g))


def tick_phase():
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = get_config("llama3.2-3b").replace(n_layers=2, dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    packed_tick(cfg, params)
    cuda = ops.CUDA
    padded_tick(cfg, params, "chunk tick C=128", 128,
                ((0, 128), (128, 128), (256, 37), (300, 0), (0, 1),
                 (64, 128), (200, 90), (500, 128)), 40, False,
                {"paged_chunk_attention": cuda})
    counts = padded_tick(
        cfg, params, "dual-branch decode tick C=1", 1,
        ((0, 1), (15, 1), (16, 1), (300, 1), (511, 1), (100, 0), (200, 1),
         (63, 1)), 64, True,
        {"paged_decode_attention": cuda, "dual_branch_decode": cuda})
    require(counts["fused_dual_branch_decode"] == 1
            and counts["paged_decode_attention"] == 1,
            f"dual tick did not run block 0 on the decode kernel and block "
            f"1 on the fused kernel: {counts}")


def padded_tick(cfg, params, label, C, lanes, tb, dual, want_paths):
    """One padded (B, C) tick at per-lane (pos, n_valid) over a random
    history: the card (kernels) against the CPU (plain versions).  Returns
    the card run's launch counts."""
    from repro_torch import interop
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    phase(f"one padded {label} at full width: card (kernel) vs CPU (plain)")
    B = len(lanes)
    bt, num_pages = lane_tables([p + C for p, _ in lanes], page=PAGE, tb=tb,
                                seed=C)
    g = torch.Generator().manual_seed(11 + C)
    n_valid = torch.tensor([n for _, n in lanes], dtype=torch.int32)
    batch = dict(tokens=torch.randint(0, cfg.vocab, (B, C), generator=g,
                                      dtype=torch.int32),
                 pos=torch.tensor([p for p, _ in lanes], dtype=torch.int32),
                 n_valid=n_valid, block_tables=bt)
    cache = M.init_paged_cache(cfg, num_pages, PAGE, B, "float32",
                               device="cpu")
    random_history(cache, g)
    plan = ExecutionPlan.single_device("paged", dual_branch=dual)
    gpu = {k: interop.tree_to(v, "cuda") for k, v in
           (("params", params), ("cache", cache), ("batch", batch))}
    ops.reset_dispatch_paths()
    ops.reset_launches()
    with torch.no_grad():
        h_gpu, c_gpu = M.paged_decode_step(gpu["params"], cfg, gpu["batch"],
                                           gpu["cache"], plan, want="hidden")
        torch.cuda.synchronize()
        paths, counts = ops.dispatch_paths(), ops.launch_counts()
        h_cpu, c_cpu = M.paged_decode_step(params, cfg, batch, cache, plan,
                                           want="hidden")
    live = torch.arange(C)[None] < n_valid[:, None]               # (B, C)
    dh = (h_gpu.cpu()[live] - h_cpu[live]).abs().max().item()
    ds = (c_gpu["a1_sig"].cpu() - c_cpu["a1_sig"]).abs().max().item()
    print(f"  (pos, n_valid) {list(lanes)}, Tb={tb}: hidden max |diff| "
          f"{dh:.3e} (max |h| {h_cpu[live].abs().max().item():.3f}); a1_sig "
          f"max |diff| {ds:.3e}; tol 1e-3 (fp32 on both sides, sums in "
          f"another order, activations of order 1); card paths {paths}; "
          f"launches {counts}", flush=True)
    require(paths == want_paths, f"card tick paths {paths} != {want_paths}")
    require(dh <= 1e-3 and ds <= 1e-3,
            "card tick disagrees with the CPU plain path")
    require(bool(torch.isfinite(h_gpu).all()),
            "non-finite hidden states on the card")
    return counts


def packed_tick(cfg, params):
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    phase("one packed tick at full width: card (kernel) vs CPU (plain)")
    num_pages, tb = 512, 72
    bt, tok_slot, tok_pos, seg_last = mixed_tick(
        page=PAGE, num_pages=num_pages, tb=tb, seed=5)
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, tok_slot.shape, generator=g,
                           dtype=torch.int32)
    batch = dict(tokens=tokens, tok_slot=tok_slot, tok_pos=tok_pos,
                 block_tables=bt, seg_last=seg_last)
    cache = M.init_paged_cache(cfg, num_pages, PAGE, seg_last.numel(),
                               "float32", device="cpu")
    random_history(cache, g)
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
    from repro_torch.kernels import ops
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
    ops.reset_launches()
    ops.reset_dispatch_paths()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    launches = counts["paged_packed_attention"]
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
            or st["packed_calls"] != st["ticks"] or sum(counts.values()) \
            != launches:
        raise AssertionError(f"kernel launches != ticks x layers: {counts}")
    if paths != {"paged_packed_attention": ops.CUDA}:
        raise AssertionError(f"engine did not run the kernel only: {paths}")
    prompts, streams = profile_phase(engine, cfg, rng)
    dual_engine_phase(cfg, params, ecfg, prompts, streams)
    return launches, dict(ticks=st["ticks"], tok_s=gen / wall,
                          wall_s=wall), params


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
        engine.finished.clear()
        for i, p in enumerate(prompts):
            engine.submit(ServeRequest(rid=100 + i, prompt=p, max_new=24))
        t0 = engine.ticks
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        streams = {r.rid: list(map(int, r.generated))
                   for r in engine.finished}
        return (time.perf_counter() - w0) * 1e3, engine.ticks - t0, streams

    wall_ms, ticks, streams = serve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_ms, prof_ticks, _ = serve()
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
        return prompts, streams
    busy = device_ms / wall_ms
    print(f"  device kernel time {device_ms:.1f} ms ({device_ms / ticks:.2f} "
          f"ms/tick): busy share {busy:.3f}, idle share {1 - busy:.3f} of "
          f"the unprofiled wall; paged_packed_attention {attn_ms:.2f} ms = "
          f"{attn_ms / device_ms:.3f} of device time")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    {ms:9.2f} ms {n:6d} calls  {key[:90]}")
    sys.stdout.flush()
    return prompts, streams


def dual_engine_phase(cfg, params, ecfg, prompts, streams):
    """The profile workload through a fresh engine with
    ``EngineConfig(dual_branch=True)``.  The packed dual path runs the
    sequential path's ops one after the other (same kernels, same
    operands, same residual association), so its token streams must equal
    the non-dual engine's, token for token."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import PagedEngine, ServeRequest
    phase("dual engine: the profile workload with EngineConfig(dual_branch="
          "True)")
    engine = PagedEngine(cfg, params,
                         dataclasses.replace(ecfg, dual_branch=True))
    # warm-up request (allocator pools), outside the count and the wall
    engine.submit(ServeRequest(rid=-1, prompt=prompts[0][:32], max_new=4))
    engine.run()
    engine.finished.clear()
    engine.reset_stats()
    for i, p in enumerate(prompts):
        engine.submit(ServeRequest(rid=100 + i, prompt=p, max_new=24))
    torch.cuda.synchronize()
    ops.reset_launches()
    ops.reset_dispatch_paths()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    ticks = engine.stats()["ticks"]
    got = {r.rid: list(map(int, r.generated)) for r in done}
    same = sum(got[k] == v for k, v in streams.items())
    print(f"  {ticks} ticks in {wall * 1e3:.1f} ms ({wall * 1e3 / ticks:.2f} "
          f"ms/tick); streams equal to the non-dual "
          f"engine's: {same}/{len(streams)}; launches {counts} (ticks x "
          f"layers = {ticks * cfg.n_layers}); paths {paths}", flush=True)
    require(got == streams, "dual engine streams differ from the non-dual "
            "engine's")
    require(counts["paged_packed_attention"] == ticks * cfg.n_layers
            and sum(counts.values()) == ticks * cfg.n_layers,
            f"dual engine launches != ticks x layers: {counts}")
    require(paths == {"paged_packed_attention": ops.CUDA},
            f"dual engine did not run the kernel only: {paths}")


def padded_generation_phase(params):
    """Padded (B, C) generation through ``paged_decode_step`` at llama3.2-3b
    full width and depth (bf16, the engine phase's weights): chunk prefill
    ticks (C = 128; lanes whose prompt has ended sit ticks out with
    n_valid = 0), then 32 greedy C == 1 ticks sequentially, and the same
    32 from the same prefilled cache under the dual-branch plan.  The
    counters are zeroed just before and read just after each of the three
    runs.  The decode runs go in turns, sequential, dual, dual, sequential,
    each from its own copy of the prefilled cache.  Returns {kernel:
    launches of the first run that drives it}."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.sampling import greedy
    B, C, tb, n_new = 8, 128, 128, 32
    cfg = get_config("llama3.2-3b")
    L = cfg.n_layers
    phase(f"padded generation: llama3.2-3b, {L} layers, bf16, {B} lanes, "
          f"C={C} prefill, {n_new} greedy decode ticks, Tb={tb}")
    rng = np.random.default_rng(3)
    lens = rng.integers(300, 513, B)
    require(lens.min() <= 3 * C < lens.max(),
            "the draw should leave some lanes idle in the last prefill tick")
    bt, num_pages = lane_tables(lens + n_new, page=PAGE, tb=tb, seed=9)
    bt = bt.cuda()
    prompts = rng.integers(0, cfg.vocab, (B, int(lens.max())))
    cache = M.init_paged_cache(cfg, num_pages, PAGE, B, "bfloat16")
    seq = ExecutionPlan.single_device("paged")
    dual = seq.with_dual_branch()
    dev = lambda a: torch.as_tensor(np.asarray(a, np.int32)).cuda()  # noqa: E731,E501

    def run_counted(fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, ops.launch_counts(), \
            ops.dispatch_paths()

    def prefill():
        first = torch.zeros((B,), dtype=torch.long, device="cuda")
        ticks = 0
        for t in range(0, int(lens.max()), C):
            nv = np.clip(lens - t, 0, C)
            tok = np.zeros((B, C), np.int64)
            tok[:, :min(C, prompts.shape[1] - t)] = prompts[:, t:t + C]
            batch = dict(tokens=dev(tok), pos=dev(np.minimum(t, lens)),
                         n_valid=dev(nv), block_tables=bt)
            h, _ = M.paged_decode_step(params, cfg, batch, cache, seq,
                                       want="hidden")
            ends = (nv > 0) & (lens <= t + C)       # prompt ends this tick
            if ends.any():
                idx = torch.as_tensor(np.nonzero(ends)[0]).cuda()
                last = dev(lens[ends] - t - 1).long()
                logits = M.lm_head(params, cfg, h[idx, last][:, None])
                first[idx] = greedy(logits[:, 0]).long()
            ticks += 1
        return first, ticks

    def decode(c, first, plan, n=n_new):
        tok, out, first_logits = first.clone(), [], None
        for i in range(n):
            batch = dict(tokens=tok[:, None].int(), pos=dev(lens + i),
                         n_valid=dev(np.ones(B)), block_tables=bt)
            logits, _ = M.paged_decode_step(params, cfg, batch, c, plan)
            if i == 0:
                first_logits = logits[:, 0].float()
            tok = greedy(logits[:, 0]).long()
            out.append(tok)
        return torch.stack(out, 1).cpu(), first_logits

    with torch.no_grad():
        (first, n_pre), pre_s, pre_counts, pre_paths = run_counted(prefill)
        require(set(pre_paths.values()) == {ops.CUDA},
                f"prefill took a non-kernel path: {pre_paths}")
        require(pre_counts == {**{k: 0 for k in pre_counts},
                               "paged_chunk_attention": n_pre * L},
                f"prefill launches {pre_counts} != {n_pre} x {L} chunk")
        print(f"  prompts {lens.tolist()}; prefill {n_pre} chunk ticks in "
              f"{pre_s:.2f} s; launches {pre_counts}")
        want = {"sequential": {"paged_decode_attention": n_new * L},
                "dual": {"paged_decode_attention": n_new,
                         "fused_dual_branch_decode": n_new * (L - 1)}}
        copies = [{k: (v.clone() if torch.is_tensor(v) else
                       {n: t.clone() for n, t in v.items()})
                   for k, v in cache.items()} for _ in range(3)] + [cache]
        # one tick of each plan first (allocations, GEMM heuristics): it
        # writes the K/V that the timed run's first tick writes again
        decode(copies[0], first, seq, n=1)
        decode(copies[1], first, dual, n=1)
        runs = {"sequential": [], "dual": []}
        for name, c in zip(("sequential", "dual", "dual", "sequential"),
                           copies):
            (toks, lg), secs, counts, paths = run_counted(
                lambda: decode(c, first, seq if name == "sequential"
                               else dual))
            print(f"  {name}: {n_new} ticks in {secs:.2f} s = "
                  f"{secs / n_new * 1e3:.2f} ms/tick, "
                  f"{B * n_new / secs:.1f} tok/s; launches {counts}",
                  flush=True)
            require(set(paths.values()) == {ops.CUDA},
                    f"{name} run took a non-kernel path: {paths}")
            require(counts == {**{k: 0 for k in counts}, **want[name]},
                    f"{name} launches {counts} != {want[name]}")
            require(bool(torch.isfinite(lg).all()), "non-finite logits")
            runs[name].append((toks, lg, counts))
    (toks_s, lg_s, seq_counts), (toks_s2, _, _) = runs["sequential"]
    (toks_d, lg_d, dual_counts), (toks_d2, _, _) = runs["dual"]
    diff = (lg_s - lg_d).abs().max().item()
    common = [int((toks_s[b] == toks_d[b]).int().cumprod(0).sum())
              for b in range(B)]
    print(f"  first decode tick: max |logit diff| sequential vs dual "
          f"{diff:.4f} (bound {DUAL_LOGIT_BOUND}; max |logit| "
          f"{lg_s.abs().max().item():.3f}); common prefix of the greedy "
          f"streams per lane {common} of {n_new}", flush=True)
    require(diff <= DUAL_LOGIT_BOUND,
            f"dual logits differ by {diff} > {DUAL_LOGIT_BOUND}")
    # the fused kernel sums its partials in a fixed order: runs repeat
    require(torch.equal(toks_s, toks_s2) and torch.equal(toks_d, toks_d2),
            "a repeated decode run gave other tokens")
    return {"paged_chunk_attention": pre_counts["paged_chunk_attention"],
            "paged_decode_attention": seq_counts["paged_decode_attention"],
            "fused_dual_branch_decode":
                dual_counts["fused_dual_branch_decode"]}


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
    errs = {"paged_packed_attention": kernel_phase(),
            **padded_kernel_phase(),
            "fused_dual_branch_decode": fused_kernel_phase()}
    times = time_phase(bw)
    main_shape = "mixed tick (256 prefill + 7 decode near 1024 + 9 pad)"
    times = {"paged_packed_attention": dict(
        times[main_shape],
        shape=main_shape + ", bf16, H=24 Hkv=8 D=128 page=16"),
        **padded_time_phase(bw)}
    tick_phase()
    launches, eng, params = engine_phase()
    launches = {"paged_packed_attention": launches,
                **padded_generation_phase(params)}
    src = "src/repro_torch/kernels/csrc/"
    where = {
        "paged_packed_attention": ("paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:346"),
        "paged_decode_attention": ("paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:106"),
        "paged_chunk_attention": ("paged_attention.cu",
                                  "src/repro/kernels/paged_attention.py:222"),
        "fused_dual_branch_decode": ("dual_branch.cu",
                                     "src/repro/kernels/dual_branch.py:122"),
    }
    kernels = []
    for kname, (source, replaces) in where.items():
        row = times[kname]
        entry = {"name": kname, "route": "cuda", "source": src + source,
                 "replaces": replaces, "launches": launches[kname],
                 "max_abs_err": errs[kname], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": None}
        if "unfused_ms" in row:
            entry["unfused_ms"] = row["unfused_ms"]
        entry["shape"] = row["shape"]
        kernels.append(entry)
    print(f"total {time.perf_counter() - t_start:.1f} s; engine "
          f"{eng['tok_s']:.1f} tok/s over {eng['ticks']} ticks; card {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
