#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printed on lines of its own; any failure raises and the
script exits non-zero:

  1. device      the card's name and power limit (nvidia-smi); TF32 off
  2. build       every kernel under src/repro_torch/kernels/csrc with nvcc,
                 one nvcc per source, all started together; registers and
                 spills of the bf16 flash kernels (none may spill at
                 D = 128), of the tensor-core attention and combine
                 kernels over packed and chunk items (bf16, int8 and fp8
                 pages), of the key-split decode kernels (bf16, int8 and
                 fp8 pages), of the bf16 fused grid and its finishing
                 kernel, of the LN-add forward at the port's shapes and of
                 the page copy (none of these may spill)
  3. kernel      each kernel against its plain PyTorch version at the
                 main path's shapes (and small shapes), bf16 and fp32; the
                 tensor-core packed kernel (bf16 q on bf16, int8 and fp8
                 pages) also on edge ticks (runs across tiles and splits,
                 one key, padding in slot 0, a slot as two runs),
                 bit-identical over two launches, and its plan kernel's
                 work list equal to packed_work_list's; the key-split
                 decode (bf16 q on bf16, int8 and fp8 pages) and the bf16
                 fused kernel also on edge lanes (seq_len 1, 255/256/257,
                 511/512, the table, 0) at G = 1, 3, 8 and D = 32, 64,
                 128, bit-identical over two launches (fused: B = 3, 8,
                 11, a ragged F tile), and on one lane of odd H over three
                 splits (the partials' 16-byte alignment); the tensor-core
                 chunk route (bf16 q on bf16, int8 and fp8 pages) on edge
                 chunks (G = 1, 3, 8; D = 32, 64, 128; C = 1 and C not a
                 multiple of 64 / G; n_valid 0 at pos 0 and > 0; chunks
                 past the table's end; with and without key splits), all
                 rows, bit-identical over two launches; fp32 decode (also
                 fp32 q on int8 pages), fused and chunk calls still on the
                 CUDA-core kernels (profiled by name); the dual-branch
                 dispatcher's two-op route;
                 page_copy byte for byte (one pool a launch; the whole
                 cache of bf16 and of int8 pages with scales in one launch
                 at n = 1, 3 with a repeated src and past the cap); the
                 int8 / fp8 scale variants of the three paged attention
                 kernels; flash_attention forward and backward
                 (bf16: the tensor-core kernels, fp32: the CUDA-core ones;
                 also against autograd through the plain forward, and
                 bit-identical over two runs) and fused_ln_add forward and
                 backward (the forward's y also without its statistics, and
                 its first rows in calls of 8 and of 1 row, bit-identical)
  4. time        kernel, plain and bound times (median of 100 launches,
                 CUDA events, L2 flushed between launches; the packed
                 kernel on a mixed and a decode-only tick; the decode,
                 chunk and fused kernels beside their times before the
                 redesign, the fused one also with its FFN blocks alone,
                 its attention items alone and its two-op route); one COW at
                 llama3.2-3b (one launch, with a lead and without) and 64
                 pages beside index_copy_; the training kernels beside
                 scaled_dot_product_attention and F.rms_norm + add (flash:
                 also TFLOP/s and share of the bound; fused_ln_add also at
                 the engine's 263 rows, the padded decode's 8 rows and with
                 fewer rows than the backward's grid, the forward also
                 without its statistics and after a read flush)
  5. tick        one packed tick (bf16, int8 and fp8 pages), one
                 speculative tick (draft and verify logits), one padded
                 C = 128 chunk tick and one dual-branch C == 1 tick of
                 llama3.2-3b at full width (2 layers, fp32) on the card
                 against the plain path on the CPU
  6. engine      24 greedy requests through PagedEngine at full width and
                 depth (llama3.2-3b, 28 layers, bf16), with the kernels'
                 launch counters zeroed just before and read just after
  7. profile     where a tick's time goes: a second, smaller workload on
                 the same engine, timed plainly and with its first
                 PROFILE_WINDOW ticks under torch.profiler
  8. dual engine the profile workload again through
                 EngineConfig(dual_branch=True): the same token streams
  8a. sampler    the seeded samplers on llama3.2-3b head logits (8 lanes,
                 and the 8 x 4 verify grid): threefry bits and tokens card
                 = CPU, fast = full on eligible lanes, ms a call
  8b. seeded     8 seeded + 2 full-sort requests twice through the engine:
                 the same streams, ticks x layers launches
  8c. spec       EngineConfig(spec_tokens=4, draft_blocks=2), greedy on the
                 random weights and seeded on late-block-damped weights,
                 each twice, then 3 seeded ticks profiled: launches =
                 ticks x layers + draft iterations x draft_blocks,
                 acceptance, tok/s and common-prefix fraction against the
                 non-spec engine
  9. prefix      the repeated-prefix workload cold and hot through
                 EngineConfig(prefix_cache=True), on bf16 and int8 pages
 10. quantized   the profile workload on int8 and on fp8 pages, the model
                 cut to its first 4 layers (QUANT_LAYERS), read against
                 the bf16 engine's streams at that depth
 11. padded      padded (B, C) generation at full width and depth: chunk
                 prefill ticks, then 16 greedy C == 1 ticks sequentially and
                 again under the dual-branch plan from the same cache; the
                 prefill again under torch.profiler from the empty cache
                 (device ms/tick, the tensor-core chunk kernel by name);
                 then 4 ticks of each plan under torch.profiler (device
                 ms/tick, the key-split decode and, bf16, the fused kernel
                 by name); then the same on int8 and on fp8 pages, 8
                 decode ticks each way
 11a. contiguous decode over the contiguous KV cache (init_cache /
                 decode_step): 12 ticks of 8 ragged lanes (one at 0, one
                 reaching S - 1, some idle on alternate ticks) at full
                 width, 2 layers, fp32, card vs CPU, sequential and dual
                 (dual bit-identical to sequential on the card); decode ==
                 forward at full depth in bf16 (B=4, S=128, every logit
                 within CONTIG_FWD_BOUND); ContinuousBatcher (8 slots,
                 bf16, 28 layers) serving 16 greedy requests of 32..128 +
                 16 tokens in one dispatch a tick (tok/s, ms a tick, 3
                 ticks profiled); obs.run_metadata naming the card
 12. train tick  one train step at llama3.2-3b full width (2 layers, fp32,
                 B=1, S=256) on the card against the CPU
 13. train       trainer.train at llama3.2-3b full width and depth (fal,
                 fp32 masters, bf16 compute, remat, B=1, S=2048): one
                 warm-up step, 5 counted steps, one profiled step
 13a. tp         explicit tensor parallelism (core/tp.py) at llama3.2-3b
                 full width cut to 4 layers, B=1, S=1024: two ranks
                 spawned on this card over gloo (named, printed; CUDA
                 tensors staged through host memory), and over NCCL too
                 where there are two cards (else init_tp_group('nccl')
                 must refuse).  Each rank: the one-device references
                 first (bf16 logits, the decode tick, and on rank 0 three
                 trainer steps), then with every counter at 0: the bf16
                 forward (logits vs one device), trainer.train 3 steps
                 (fp32 masters, remat; losses and grad norms vs one
                 device; step ms, labelled gloo through host memory),
                 forward + backward of fal and preln (all-reduce counts
                 and bytes, fal / preln = (L + 1) / (2 L) = 5/8) and of
                 their SP layouts (ar + tp x rs bytes = the replicated
                 bytes), and one steady-state block's padded decode tick
                 sequential and dual (one all-reduce each; Hkv 4 pages,
                 d_ff 4096 shards) vs one device; then TP serving (fp32
                 and bf16 weights at the same width and depth): one fp32
                 packed tick, one padded chunk tick and the C == 1
                 dual-branch tick after it (L + 1 all-reduces each; logits
                 vs one device, equal on both ranks); PagedEngine serving
                 8 greedy requests with a prefix copy-on-write, fp32
                 (streams equal one device's) and bf16 (a first divergence
                 only at a one-device top-2 gap <= TP_LOGIT_TOL); one
                 int8-page tick (pools gathered over heads vs one device)
                 and the int8 scatter of the same rows (byte for byte, one
                 MAX all-reduce); then the ssm, hybrid and audio families
                 at full width in fp32 (whisper-small 2 + 2 layers over
                 1,500 frames, zamba2-1.2b 13 layers, mamba2-370m 2
                 layers): forward logits and one train step vs the
                 one-device run of the seed (TP_SERVE_FP32_TOL), 16 greedy
                 decode ticks' tokens equal to one device's, all-reduce
                 counts and the flash / LN-add launches (forward and
                 backward) exact, every path cuda-kernel.  flash_attention
                 (and .bwd), fused_ln_add (and .bwd),
                 paged_decode_attention and fused_dual_branch_decode must
                 launch in every rank; a failing rank fails the run
 13b. dp         tp 2 x dp 2: four gloo ranks on this card
                 (core.tp.run_ranks(..., tp_size=2); init_tp_group('nccl')
                 must refuse four ranks on one card), llama3.2-3b's
                 widths, 2 layers and a 16384-token vocabulary (gloo
                 measures no NCCL time), fp32 compute (the reference's int8 gate
                 is against an fp32 all-reduce), remat, a global batch of
                 2 x 1024 (one row a data rank): rank 0 first trains 2
                 steps on one device; then 2 steps each of grad_compress
                 none (losses and grad norms vs one device; one DP
                 all-reduce a step of exactly the local gradient bytes),
                 int8 and lowrank (forward collectives equal to none's;
                 backward wire bytes int8 <= 0.3 of none's, lowrank below;
                 the first step's gradient error vs none's); DP
                 all-reduces timed (gloo through host memory, not NCCL);
                 the none state saved (gathered over TP, one-device
                 format) and restored into one device on the card bit for
                 bit; each rank's launches, every path cuda-kernel; then
                 FSDP (plan fsdp=True: the shard cut to the data rank's
                 slices) for 2 steps of the same batches: losses and
                 norms vs one device, the params gathered vs none's
                 (1e-6 + 1e-4 of a leaf's largest value), one all-gather
                 a unit a pass and one reduce-scatter a unit, the state's
                 bytes equal to launch/dryrun.py's lower_pair at
                 Mesh(1, 2, 2) (arguments less the tokens), the peak
                 (reset with only the FSDP state on the card) within
                 DRYRUN_PEAK_RTOL of its predicted peak; cuda-kernel on
                 the flash_attention and fused_ln_add sites; then the
                 reference's decode-cache layout (launch/mesh.py
                 cache_specs, the KV sequence cut over ranks): llama3.2-3b
                 at full width, 4 layers, fp32, one row over a 32,768-
                 position cache (the sequence over data 2, the KV heads
                 over model 2), 16 greedy ticks from a seeded history
                 (the first in data rank 0's half, the last two past the
                 end); deepseek-v3-671b's three dense layers at full
                 width, bf16, over an 8,192-position latent cut over
                 model 2 at batch 2 (rows over data) and over data x
                 model at batch 1, 8 ticks each: every rank's tokens and
                 logits vs one device on the card (fp32: tokens equal,
                 logits within TP_SERVE_FP32_TOL; bf16: tokens equal or
                 the first divergence reported, logits up to it within
                 TP_LOGIT_TOL), ranks serving the same rows bit-equal,
                 each rank's cache bytes equal to
                 specs.decode_input_specs' at tp 2 x dp 2, the seq
                 collectives a tick exact, one fused_ln_add launch a
                 layer a tick
 14. gemma2      gemma2-27b at full width cut to 2 layers (block 0 local,
                 block 1 global; every layer softcapped): one packed, one
                 padded chunk, one padded decode and one contiguous decode
                 tick and one train step
                 (fp32, window 128, B=1, S=144) on the card against the
                 CPU; trainer.train (fp32 masters, bf16 compute, remat,
                 B=1, S=6144: 1 warm-up, 3 counted, 1 profiled step) with a
                 checkpoint, which is restored on the card and stepped
                 again bit for bit like the uninterrupted run; 4 greedy
                 requests of 4200..5200 prompt tokens through PagedEngine
                 (bf16, window 4096) twice, the same streams, and three
                 ticks profiled.  Phase 3 also holds the six flash kernels
                 with window and cap (gemma2's heads, S = 6144 and edge
                 cases) to their plain versions, and phase 4 times them at
                 gemma2's training shape
 15. moe         qwen3-moe-30b-a3b (128 experts of 768, top 8, G = 8):
                 at full width, 2 layers, fp32, one packed, one padded
                 chunk, one padded C == 1 tick under the dual-branch plan
                 (MoE blocks take the unfused route: no fused launch), 4
                 contiguous decode ticks and one train step (B=1, S=128),
                 card vs CPU with the routing compared (a token may choose
                 other experts only at a near tie, MOE_GAP_EPS, and its
                 sequence is then left out of the gate); the engine at
                 full width and depth (48 layers, bf16, 60.4 GB) serving
                 16 greedy requests of 64..512 + 16 (packed and LN-add
                 launches = ticks x 48, no fused dual-branch launch), 2
                 prefill ticks profiled with the share of dropped (token,
                 expert) pairs, and again under dual_branch (the same
                 streams); trainer.train at 2 layers (1.56 B parameters,
                 fp32 masters, bf16 compute, remat, B=1, S=2048: 1 warm-up,
                 3 counted, 1 profiled step); then two gloo ranks: explicit
                 TP in fp32 (2 layers, S=512, 64 experts a rank: logits
                 and one trainer step vs one device, fal's L + 1
                 all-reduces), and expert parallelism on bf16 layers
                 against moe_apply on one device (a qwen3-moe layer through
                 moe_apply_sharded, a deepseek-v3 layer (d 7168, 256
                 experts of 2048, top 8, 16 groups limit 4, a shared
                 expert) through moe_apply_shard_slot; capacity E / k, so
                 nothing drops), with their all-to-all counts and bytes
 16. mla / vlm   deepseek-v3's latent attention and MTP head, llava's
                 image prefix (see the functions' docstrings)
 17. families    mamba2-370m (ssm), zamba2-1.2b (hybrid) and whisper-small
                 (audio): (a) fp32 at full width, card vs CPU (mamba 2
                 layers at S = 512, two SSD chunks; zamba 13 layers: two
                 groups and a trailing layer; whisper 2 + 2 layers, 1,500
                 frames, T = 64): logits, loss, gradient norm and 16
                 decode_step ticks; (b) bf16 serving at full depth: mamba
                 (48 layers) and zamba (38, also dual-branch) through
                 ContinuousBatcher (8 slots, 16 requests of 16 + 16, slots
                 reused), decode == forward within FAMILY_FWD_BOUND;
                 whisper (12 + 12) encoding 8 x 1,500 frames and
                 generating 64 tokens, decode == forward; (c) training at
                 full depth (fp32 masters, bf16 compute, remat): mamba
                 (B = 4) and zamba (B = 2) at S = 1024, whisper with
                 1,500 frames and T = 448; step ms, tokens/s, peak
                 memory, busy share.
                 Phase 3 also holds the flash kernels at whisper's shapes
                 (1500 x 1500 non-causal, 448 x 1500 and 1 x 1500 cross)
                 to their plain versions, and phase 4 times them
 18. analysis    benchmarks/bench_motivation.py's model (6 layers, d 192,
                 preln, fp32) trained 150 steps on the card, then every
                 core.analysis function (Fig 3a CKA, Fig 4a gradient
                 magnitudes, Fig 4b / 3b ablation perplexities) on the
                 card (flash forward and backward kernels) and on the CPU
                 on the same weights: parity gated, findings printed
 13c. dry run    (right after phase 13) the meta route's workspace sizes
                 against the libraries' sizing functions; then
                 launch/dryrun.py's lower_pair on
                 the meta device (no card) for phase 13's workload at
                 model 1 x data 1: its argument bytes equal the state and
                 tokens phase 13 built, its peak within DRYRUN_PEAK_RTOL
                 of phase 13's max_memory_allocated; its flops over the
                 measured step time as TFLOP/s
 19. examples    examples/torch_*.py at their defaults, each in a process
                 of its own, started together: exit 0 (their own asserts),
                 cuda-kernel on every dispatch site, and the kernels of
                 EXAMPLES launched

The serving phases (5 to 11a, 14, 15) also launch fused_ln_add: one per layer
per tick under fal (on the contiguous cache the only kernel a tick runs).
Every main-path run (6, 8, 8b, each run of 8c and of 9 to 11a, the counted
steps of 13 and 14, the TP paths of 13a and the DP paths of 13b in each
rank, each gemma2 engine run, and in 15 each MoE engine run, the counted
train steps and each rank's TP forward and trainer step; in 17 each
family's serving and training run) zeroes all launch counters just before
it and reads them just after.  The line before the last is a
JSON object with one entry per kernel; the last line is {"ok": true,
"device": {...}}.  Without a CUDA device, or outside a checkout, the script
exits non-zero and prints no result.  It imports nothing of JAX and nothing
of the JAX package ``repro``.
"""
import contextlib
import gc
import itertools
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import tempfile
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
MOE_H, MOE_HKV = 32, 4                   # qwen3-moe-30b-a3b's (G = 8)

#: bound on |logit| differences between sequential and dual-branch decode
#: at llama3.2-3b in bf16 (padded generation phase).  Attention is the same
#: kernel code on both routes; the FFN differs: the fused kernel keeps x @ wg,
#: x @ wi and the activation in fp32 and rounds y once, where mlp_apply rounds
#: each of them to bf16 (relative 2^-9 each).  Those differences enter the
#: residual stream in each of 27 blocks and reach logits of order 1 through
#: the final norm.
DUAL_LOGIT_BOUND = 0.25


_T0 = time.perf_counter()


def phase(name):
    """Print a phase's heading with the seconds since the script started."""
    print(f"== {name} [{time.perf_counter() - _T0:.1f} s]", flush=True)


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


def common_prefix(a, b):
    """Length of the common prefix of two token sequences."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


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
    # ptxas -v's reports, of this run's builds or kept beside cached ones
    for name, log in build.PTXAS_LOG.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spill = [int(m) for m in re.findall(r"(\d+) bytes spill", log)]
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)]
        print(f"  {name}: {len(regs)} kernels, {min(regs)}..{max(regs)} "
              f"registers, at most {max(smem, default=0)} bytes static "
              f"shared memory, {sum(spill)} bytes spilled (ptxas -v)")
        for kname, spilled in spilling_kernels(log):
            print(f"    spills {spilled} bytes: {kname}")
    tc = tensor_core_kernels(build.PTXAS_LOG.get("flash_attention", ""))
    for (kname, _, d, cap), (regs, spilled) in sorted(tc.items()):
        print(f"  flash_attention bf16 {kname}{' (softcap)' if cap else ''} "
              f"D={d}: {regs} registers at launch (setmaxnreg moves them to "
              f"the consumers), {spilled} bytes spilled")
    want = {(kname, "", d, cap) for kname in ("fwd_kernel", "dkdv_kernel",
                                              "dq_kernel")
            for d in (32, 64, 128, 192) for cap in ("", "cap")}
    require(set(tc) == want, f"ptxas reported {sorted(tc)}, not the 24 bf16 "
            f"flash kernels (3 kernels x 4 head dims, with and without the "
            f"softcap)")
    require(all(sp == 0 for (_, _, d, _), (_, sp) in tc.items()
                if d in (128, 192)),
            "a bf16 flash kernel spills at D = 128 or 192 (MLA)")
    # the tensor-core attention and combine kernels over the packed and the
    # chunk layouts' items
    packed = tensor_core_kernels(build.PTXAS_LOG.get("paged_attention", ""),
                                 "9packed_tc")
    for (kname, pages, d, items), (regs, spilled) in sorted(packed.items()):
        label = {"Packed": "paged_packed_attention",
                 "Chunk": "paged_chunk_attention"}.get(items, items)
        print(f"  {label} {kname} {pages + ' pages ' if pages else ''}D={d}: "
              f"{regs} registers, {spilled} bytes spilled")
    want = sorted([("attn_kernel", pages, d, items)
                   for pages in PAGE_TYPES.values() for d in (32, 64, 128)
                   for items in ("Packed", "Chunk")]
                  + [("combine_kernel", "", d, items) for d in (32, 64, 128)
                     for items in ("Packed", "Chunk")])
    require(sorted(packed) == want, f"ptxas reported {sorted(packed)}, not "
            f"the {len(want)} tensor-core packed and chunk kernels")
    require(all(sp == 0 for _, sp in packed.values()),
            "a tensor-core packed or chunk attention kernel spills")
    # the decode key splits over bf16, int8 and fp8 pages
    # (paged_attention.cu) and the bf16 fused grid (dual_branch.cu): every
    # instantiation, none may spill
    split = templated_kernels(build.PTXAS_LOG.get("paged_attention", ""),
                              ("split_kernel", "combine_kernel"),
                              "13decode_splits")
    dual = templated_kernels(build.PTXAS_LOG.get("dual_branch", ""),
                             ("dual_tc_kernel", "dual_finish_kernel"))
    for label, found in (("paged_decode_attention", split),
                         ("fused_dual_branch_decode", dual)):
        for (kname, pages, d, mg), (regs, spilled) in sorted(found.items()):
            before = SPLIT_BF16_REGS.get((kname, pages, d, mg))
            print(f"  {label} {kname} {pages + ' pages ' if pages else ''}"
                  f"D={d}{f' G<={mg}' if mg else ''}: {regs} registers"
                  f"{f' (was {before})' if before else ''}, "
                  f"{spilled} bytes spilled")
    want = {("split_kernel", pages, d, g) for pages in PAGE_TYPES.values()
            for d in (32, 64, 128) for g in (4, 8)}
    want |= {("combine_kernel", "", d, 0) for d in (32, 64, 128)}
    require(set(split) == want, f"ptxas reported {sorted(split)}, not the "
            f"{len(want)} key-split decode kernels")
    want = {("dual_tc_kernel", "", d, g) for d in (32, 64, 128)
            for g in (4, 8)}
    want |= {("dual_finish_kernel", "", d, 0) for d in (32, 64, 128)}
    require(set(dual) == want, f"ptxas reported {sorted(dual)}, not the "
            f"{len(want)} bf16 fused kernels")
    require(all(sp == 0 for _, sp in list(split.values())
                + list(dual.values())),
            "a key-split decode or bf16 fused kernel spills")
    # the LN-add forward over (dtype, vector width, vectors a thread, kind):
    # every instantiation built, none of the port's shapes may spill; and
    # the cache-wide page copy, which may not spill
    fwd = ln_fwd_kernels(build.PTXAS_LOG.get("fused_ln_add", ""))
    want = {(t, vec, nv, kind) for t, vecs in (("bf16", (8, 4, 2, 1)),
                                               ("fp32", (4, 2, 1)))
            for vec in vecs for nv in (1, 2, 3) + {4: (4,), 2: (4, 8),
                                                   1: (4, 8, 16)}.get(vec, ())
            for kind in ("rmsnorm", "layernorm")}
    require(set(fwd) == want, f"ptxas reported {len(fwd)} forward LN-add "
            f"kernels, not the {len(want)} instantiations")
    main = {ln_fwd_instance(kind, d, t) for kind, _, d in LN_SHAPES
            for t in ("bf16", "fp32")}
    for key in sorted(main):
        regs, spilled = fwd[key]
        print(f"  fused_ln_add forward {key[0]} VEC={key[1]} NV={key[2]} "
              f"{key[3]}: {regs} registers, {spilled} bytes spilled")
    rare = sorted(k for k, (_, sp) in fwd.items() if sp and k not in main)
    print(f"  fused_ln_add forward instantiations no shape of the port "
          f"takes that spill: {rare or 'none'}")
    copy = entry_stats(build.PTXAS_LOG.get("page_copy", ""),
                       "page_copy_kernel")
    print(f"  page_copy: {len(copy)} kernel(s), "
          f"{sorted(copy.values())} (registers, bytes spilled)")
    require(len(copy) == 1, "ptxas reported no page_copy kernel")
    require(all(fwd[k][1] == 0 for k in main)
            and all(sp == 0 for _, sp in copy.values()),
            "a forward LN-add kernel of the port's shapes or the page-copy "
            "kernel spills")
    sys.stdout.flush()


def ln_fwd_instance(kind, d, dtype):
    """(dtype, VEC, NV, kind) of the forward LN-add kernel a row of width d
    launches (``fwd_row_threads`` and ``fwd`` in csrc/fused_ln_add.cu, on
    allocator-aligned tensors): 16-byte vectors where d allows, one warp a
    row of at most 96 vectors, else 32 ceil(nv / 64) threads (at most
    512), NV = ceil(nv / threads) rounded up to 1, 2, 3, 4, 8 or 16."""
    vec = 8 if dtype == "bf16" else 4
    while d % vec:
        vec //= 2
    nv = d // vec
    threads = 32 if nv <= 96 else 32 * min(-(-nv // 64), 16)
    nvt = -(-nv // threads)
    return dtype, vec, min(n for n in (1, 2, 3, 4, 8, 16) if n >= nvt), kind


def entry_stats(log, name):
    """{mangled entry: (registers, bytes spilled)} of the kernels whose
    mangled name holds ``name``, from ptxas -v's report."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if name in m.group(1) else None
            if cur:
                out[cur] = [0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
            cur = None
    return {k: tuple(v) for k, v in out.items()}


def ln_fwd_kernels(log):
    """{(dtype, VEC, NV, kind): (registers, bytes spilled)} of the forward
    LN-add kernel template ``ln_add_fwd_kernel<T, VEC, NV, LN>`` from
    ptxas -v's report."""
    kern = re.compile(r"17ln_add_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)ELi"
                      r"(\d+)ELb([01])E")
    out = {}
    for name, stats in entry_stats(log, "ln_add_fwd_kernel").items():
        k = kern.search(name)
        if k:
            out[("fp32" if k.group(1) == "f" else "bf16", int(k.group(2)),
                 int(k.group(3)),
                 "layernorm" if k.group(4) == "1" else "rmsnorm")] = stats
    return out


#: registers of the bf16 key-split decode kernels for G <= 4 before they
#: took the page type as a template parameter (PERF.md section 6), printed
#: beside this build's
SPLIT_BF16_REGS = {("split_kernel", "bf16", 128, 4): 120,
                   ("split_kernel", "bf16", 64, 4): 119,
                   ("split_kernel", "bf16", 32, 4): 113}


def spilling_kernels(log):
    """[(mangled kernel name, bytes spilled)] of the kernels in a ptxas -v
    report that spill."""
    return [(k, sp) for k, (_, sp) in entry_stats(log, "").items() if sp]


#: mangled page type of a tensor-core packed attention kernel -> its name
PAGE_TYPES = {"13__nv_bfloat16": "bf16", "a": "int8", "13__nv_fp8_e4m3": "fp8"}


def tensor_core_kernels(log, namespace="2tc"):
    """{(kernel, page type or "", D, item source or softcap or ""):
    (registers, bytes spilled)} of the kernel templates over (a page type
    and) D (and an item source or the softcap flag) in a mangled namespace
    (``2tc``: the bf16 flash kernels of csrc/flash_attention.cu, over D and
    kCap, the capped ones named "cap"; ``9packed_tc``: the tensor-core
    attention of csrc/paged_packed_tc.cuh, its attention kernel over bf16,
    int8 and fp8 pages, and it and the combine over ``PackedItems`` or
    ``ChunkItems``, named "Packed" / "Chunk") from ptxas -v's report."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + namespace +
                      r"(\d+)(\w+?_kernel)I(\w*?)Li(\d+)E(?:Lb([01])E)?"
                      r"(?:NS_\d+(\w+?)ItemsE)?", line)
        if m:
            cur = (m.group(2), PAGE_TYPES.get(m.group(3), m.group(3)),
                   int(m.group(4)),
                   m.group(6) or ("cap" if m.group(5) == "1" else ""))
            out[cur] = [0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
            cur = None
    return {k: tuple(v) for k, v in out.items()}


def templated_kernels(log, names, scope=""):
    """{(kernel, page type or "", D, G bound or 0): (registers, bytes
    spilled)} of the kernel templates ``names`` over (a page type,) D (and
    the query-group bound MG) from ptxas -v's report; with ``scope``, only
    entries whose mangled name holds it (a namespace)."""
    out, cur = {}, None
    pat = re.compile(r"Compiling entry function '(\S+)'")
    kern = re.compile(r"\d+(" + "|".join(names) +
                      r")I(\w*?)Li(\d+)E(?:Li(\d+)E)?E")
    for line in log.splitlines():
        m = pat.search(line)
        if m:
            k = kern.search(m.group(1))
            cur = None
            if k and scope in m.group(1):
                cur = (k.group(1), PAGE_TYPES.get(k.group(2), k.group(2)),
                       int(k.group(3)), int(k.group(4) or 0))
                out[cur] = [0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
            cur = None
    return {k: tuple(v) for k, v in out.items()}


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
        # the MoE engine's tick (phase 15): G = 8 over 4 KV heads
        check_kernel(PA, dtype, tick, MOE_H, MOE_HKV, D, PAGE, num_pages,
                     tols[dtype], seed=14)
    check_plan(PA, tick, MOE_H, MOE_HKV, D, PAGE)
    for d, page, h, hkv in ((64, 16, 6, 2), (32, 16, 8, 2), (128, 4, 12, 4),
                            (128, 8, 4, 4), (64, 4, 16, 2), (32, 8, 3, 1)):
        small = mixed_tick(page=page, num_pages=256, tb=96 // page * 4,
                           n_prefill=37, n_decode=3, decode_pos=90, n_pad=3,
                           seed=d + page)
        for dtype in (torch.bfloat16, torch.float32):
            check_kernel(PA, dtype, small, h, hkv, d, page, 256,
                         tols[dtype], seed=d * page)
        check_plan(PA, small, h, hkv, d, page)
    # an odd count of split partials (3 splits x 43 tokens x 3 heads): the
    # workspace's fp32 accumulators still start on a 16-byte boundary
    odd = mixed_tick(page=8, num_pages=256, tb=80, n_prefill=37, n_decode=3,
                     decode_pos=600, n_pad=3, seed=7)
    check_kernel(PA, torch.bfloat16, odd, 3, 1, 32, 8, 256,
                 tols[torch.bfloat16], seed=7)
    # the bf16 packed kernel's edges (tests/test_torch_packed_tiles.py)
    for page, g, d in EDGE_SHAPES:
        edge = edge_tick(page)
        check_kernel(PA, torch.bfloat16, edge, 2 * g, 2, d, page,
                     edge[0].numel() + 1, tols[torch.bfloat16],
                     seed=page * g)
        check_plan(PA, edge, 2 * g, 2, d, page)
    decode = decode_tick(page=PAGE, num_pages=num_pages, tb=tb)
    verify, draft = spec_ticks(page=PAGE, num_pages=num_pages, tb=tb)
    # the speculative engine's two shapes: 4-row decode segments that see
    # rows written in the same call, and the draft's one row a lane
    for t in (verify, draft):
        for dtype in (torch.bfloat16, torch.float32):
            check_kernel(PA, dtype, t, H, HKV, D, PAGE, num_pages,
                         tols[dtype], seed=12)
    for label, t in (("mixed", tick), ("decode", decode),
                     ("spec verify", verify), ("spec draft", draft)):
        check_plan(PA, t, H, HKV, D, PAGE)
        check_repeat(PA, label, t, H, HKV, D, PAGE, num_pages)
    edge = edge_tick(4)
    check_repeat(PA, "edge", edge, 16, 2, 128, 4, edge[0].numel() + 1)
    return errs[torch.bfloat16]


#: (page, G, D) of the edge ticks, as tests/test_torch_packed_tiles.py's
EDGE_SHAPES = ((4, 1, 32), (16, 1, 128), (4, 3, 64), (16, 3, 32),
               (4, 8, 128), (16, 8, 64))


def edge_tick(page):
    """tests/test_torch_packed_tiles.py's tick (table width 512 keys): slot
    0 a 70-token run from 0, then 3 padding rows in slot 0; slot 1 20
    tokens at 245..264 (across the 256-key split); slot 4 at 10..12, slot
    2 one token at 0, slot 4 again at 13..14 (two runs); slot 3 one token
    at 300.  CPU int32 (block_tables, tok_slot, tok_pos); the pool has 5 x
    Tb + 1 pages."""
    tb = 512 // page
    g = torch.Generator().manual_seed(page)
    bt = (torch.randperm(5 * tb, generator=g) + 1).to(torch.int32)
    runs = [(0, range(70)), (0, [-1] * 3), (1, range(245, 265)),
            (4, range(10, 13)), (2, [0]), (4, range(13, 15)), (3, [300])]
    tok_slot = [s for s, ps in runs for _ in ps]
    tok_pos = [p for _, ps in runs for p in ps]
    return (bt.reshape(5, tb), torch.tensor(tok_slot, dtype=torch.int32),
            torch.tensor(tok_pos, dtype=torch.int32))


#: last known positions of the speculative ticks' decode lanes: across
#: page and split boundaries; lanes 3 and 6 do not speculate
SPEC_POS = (15, 16, 63, 64, 255, 256, 700, 1020)
SPEC_LANES = (True, True, True, False, True, True, False, True)


def spec_ticks(*, page, num_pages, tb, n=4, n_prefill=100, n_pad=5, seed=3):
    """A speculative verify tick and its draft tick as ``make_spec_step``
    lays them out, over one set of tables.  Verify: each speculating lane
    of ``SPEC_POS`` packs n rows (pos..pos+n-1), the others one, then a
    prefill lane 8 at 0..n_prefill-1 and padding.  Draft: one row a lane,
    slot s at SPEC_POS[s] when it speculates, else padding in slot s (as
    the draft packs it).  CPU int32 (block_tables, tok_slot, tok_pos)
    each."""
    g = torch.Generator().manual_seed(seed)
    perm = (torch.randperm(num_pages - 1, generator=g) + 1).to(torch.int32)
    last = [p + n - 1 for p in SPEC_POS] + [n_prefill - 1]
    bt = torch.zeros((len(last), tb), dtype=torch.int32)
    used = 0
    for s, p in enumerate(last):
        k = p // page + 1
        bt[s, :k] = perm[used:used + k]
        used += k
    slot, pos = [], []
    for s, (p, on) in enumerate(zip(SPEC_POS, SPEC_LANES)):
        slot += [s] * (n if on else 1)
        pos += list(range(p, p + (n if on else 1)))
    slot += [len(SPEC_POS)] * n_prefill + [0] * n_pad
    pos += list(range(n_prefill)) + [-1] * n_pad
    d_pos = [p if on else -1 for p, on in zip(SPEC_POS, SPEC_LANES)] + [-1]
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)     # noqa: E731
    return ((bt, i32(slot), i32(pos)),
            (bt, torch.arange(len(last), dtype=torch.int32), i32(d_pos)))


def check_plan(PA, tick, h, hkv, d, page):
    """The bf16 packed kernel's plan kernel against the plain builder."""
    bt, tok_slot, tok_pos = tick[:3]
    q = torch.empty(tok_slot.numel(), h, d, dtype=torch.bfloat16,
                    device="cuda")
    kp = torch.empty(1, page, hkv, d, dtype=torch.bfloat16, device="cuda")
    got = PA.paged_packed_plan_cuda(q, kp, bt.cuda(), tok_slot.cuda(),
                                    tok_pos.cuda())
    want = PA.packed_work_list(tok_slot, tok_pos, G=h // hkv, Hkv=hkv,
                               page=page, Tb=bt.shape[1])
    print(f"  plan H={h} Hkv={hkv} page={page} T={tok_slot.numel()}: "
          f"{got.shape[0]} items (packed_work_list: {want.shape[0]})",
          flush=True)
    require(torch.equal(got, want), "the plan kernel's work list differs "
            "from packed_work_list's")


def check_repeat(PA, label, tick, h, hkv, d, page, num_pages, kv=""):
    """Two launches of the tensor-core packed kernel (bf16 q; bf16 pages,
    or ``kv`` pages with row scales) on the same inputs give the same bits
    (splits combine in a fixed order, no atomics)."""
    bt, tok_slot, tok_pos = (x.cuda() for x in tick[:3])
    q, kp, vp = attention_inputs(torch.float32 if kv else torch.bfloat16,
                                 tok_slot.numel(), h, hkv, d, page,
                                 num_pages, seed=11)
    scales = {}
    if kv:
        kp, vp, ks, vs = quantize_pools(kp, vp, kv)
        q, scales = q.to(torch.bfloat16), dict(k_scale=ks, v_scale=vs)
    a, b = (PA.paged_packed_attention_cuda(q, kp, vp, bt, tok_slot, tok_pos,
                                           **scales) for _ in range(2))
    same = torch.equal(a, b)
    print(f"  bf16 q, {kv or 'bf16'} pages, {label} tick twice: "
          f"bit-identical {same}", flush=True)
    require(same, f"two launches on the {label} tick differ ({kv or 'bf16'} "
            f"pages)")


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
    check_split_edges(PA)
    check_split_alignment()
    check_chunk_edges(PA)
    return errs


#: (H, Hkv, D, page, Tb, C) of the tensor-core chunk route's edge checks:
#: G = 8, 1 and 3 at D = 32, 64 and 128; C not a multiple of 64 / G, C = 1;
#: tables of 640 and 2048 keys; few row-tile items (key splits) and, at the
#: last two, B x ceil(C / (64 / G)) x Hkv >= CHUNK_SPLIT_ITEMS (one split)
CHUNK_EDGE_SHAPES = ((16, 2, 32, 16, 40, 37), (2, 2, 64, 4, 160, 100),
                     (6, 2, 128, 8, 80, 1), (16, 2, 128, 16, 128, 56),
                     (32, 4, 64, 16, 40, 64), (16, 16, 32, 4, 160, 128))


def chunk_edge_lanes(C, max_keys):
    """(pos, n_valid) of the chunk edge checks: a full chunk at 0; n_valid
    0 at pos 0 (no row sees a key) and at pos > 0; one valid row; n_valid
    < C just below the 256-key split boundary; a full chunk across it;
    pos + C past the table's end; a full chunk ending at it."""
    return [(0, C), (0, 0), (300, 0), (5, 1), (250, max(C - 3, 1)),
            (256 - C // 2, C), (max_keys - C // 2, C // 2),
            (max_keys - C - 1, C)]


def chunk_route(PA, B, C, h, hkv, max_keys):
    """How the tensor-core chunk route cuts a call: its split length and
    split count (``chunk_split_keys``), as text."""
    L = PA.chunk_split_keys(B, C, G=h // hkv, Hkv=hkv, max_keys=max_keys)
    n = -(-max_keys // L)
    return f"{n} split{'s' if n > 1 else ''} of {L} keys"


def chunk_case(PA, dtype_kv, C, lanes, h, hkv, d, page, tb, seed):
    """``chunk_inputs`` with bf16 q on ``dtype_kv`` pages ("" for bf16,
    else int8 / fp8 with row scales): (args, scales)."""
    args = chunk_inputs(torch.float32, C, lanes, h, hkv, d, page, tb, seed)
    q, kp, vp = args[:3]
    if not dtype_kv:
        return ((q.to(torch.bfloat16), kp.to(torch.bfloat16),
                 vp.to(torch.bfloat16), *args[3:]), {})
    kq, vq, ks, vs = quantize_pools(kp, vp, dtype_kv)
    return ((q.to(torch.bfloat16), kq, vq, *args[3:]),
            dict(k_scale=ks, v_scale=vs))


def check_chunk_edges(PA):
    """The tensor-core chunk route (bf16 q on bf16, int8 and fp8 pages) on
    the edge shapes, all rows against the plain version within
    ATTN_TOLS[bf16], rows that see no key exact zeros, two launches
    bit-identical; then the same, but for the zeros, at the timed chunk
    tick (8 lanes x C = 128 at pos 256: one split) and at a shape that
    takes splits (2 lanes x C = 128 at pos 1800 of a 2048-key table)."""
    bf16 = torch.bfloat16
    for i, (h, hkv, d, page, tb, c) in enumerate(CHUNK_EDGE_SHAPES):
        lanes = chunk_edge_lanes(c, tb * page)
        route = chunk_route(PA, len(lanes), c, h, hkv, tb * page)
        require(route.startswith("1 split") == (i >= 4),
                f"chunk edge shape {i} is on the wrong side of the split "
                f"rule: {route}")
        for kv in ("", *KV_NARROW):
            args, sc = chunk_case(PA, kv, c, lanes, h, hkv, d, page, tb,
                                  seed=800 + i)
            out = PA.paged_chunk_attention_cuda(*args, **sc)
            again = PA.paged_chunk_attention_cuda(*args, **sc)
            ref = PA.paged_chunk_attention_plain(
                args[0].float(), *args[1:], **sc).to(bf16)
            torch.cuda.synchronize()
            report(f"chunk edges bf16 q {kv or 'bf16'} pages H={h} Hkv={hkv} "
                   f"D={d} page={page} Tb={tb} C={c} ({route}) (pos, "
                   f"n_valid)={lanes}, all rows", max_err(out, ref),
                   ATTN_TOLS[bf16])
            require(out[1].abs().max().item() == 0.0,
                    "chunk rows with no visible key are not exactly 0")
            require(torch.equal(out, again), f"two launches of the chunk "
                    f"route differ ({kv or 'bf16'} pages)")
    timed = [(256, n) for n in (128, 128, 44, 128, 100, 128, 0, 128)]
    for label, lanes in (("timed chunk tick", timed),
                         ("long history", [(1800, 128), (1900, 100)])):
        route = chunk_route(PA, len(lanes), 128, H, HKV, 128 * PAGE)
        for kv in ("", *KV_NARROW):
            args, sc = chunk_case(PA, kv, 128, lanes, H, HKV, D, PAGE, 128,
                                  seed=900)
            a, b = (PA.paged_chunk_attention_cuda(*args, **sc)
                    for _ in range(2))
            ref = PA.paged_chunk_attention_plain(
                args[0].float(), *args[1:], **sc).to(bf16)
            torch.cuda.synchronize()
            report(f"bf16 q, {kv or 'bf16'} pages, chunk {label} {lanes} "
                   f"({route}), all rows", max_err(a, ref), ATTN_TOLS[bf16])
            same = torch.equal(a, b)
            print(f"  bf16 q, {kv or 'bf16'} pages, chunk {label} {lanes} "
                  f"({route}) twice: bit-identical {same}", flush=True)
            require(same, f"two chunk launches differ ({label}, "
                    f"{kv or 'bf16'} pages)")
    print("  chunk edges: no-key rows exact zeros, repeats bit-identical",
          flush=True)


#: (H, Hkv, D, page, Tb) of the bf16 key-split decode's edge checks: G = 1,
#: 3 and 8 at D = 32, 64 and 128, tables of 640 keys (3 splits of 256) and
#: 2048 keys (8 splits), and the main shape
SPLIT_EDGE_SHAPES = ((2, 2, 32, 16, 40), (6, 2, 32, 4, 160),
                     (16, 2, 32, 16, 128), (2, 2, 64, 8, 80),
                     (6, 2, 64, 16, 40), (16, 2, 64, 4, 160),
                     (2, 2, 128, 4, 160), (6, 2, 128, 16, 128),
                     (16, 2, 128, 8, 80), (H, HKV, D, PAGE, 128))


def edge_lanes(tb, page):
    """Lane lengths across the split boundaries: one key, 255/256/257,
    511/512, the whole table, and an empty lane."""
    return [1, 255, 256, 257, 511, 512, tb * page, 0]


def check_split_edges(PA):
    """The key-split decode of bf16 q on bf16, int8 and fp8 pages on the
    edge lanes: live lanes within ATTN_TOLS[bf16] of the plain version, the
    empty lane exact zeros, two launches bit-identical (splits merge in
    split order).  One-byte pools are the fp32 draws quantized as the
    engine quantizes them (``quantize_pools``)."""
    bf16 = torch.bfloat16
    for kv in ("", *KV_NARROW):
        for i, (h, hkv, d, page, tb) in enumerate(SPLIT_EDGE_SHAPES):
            lens = edge_lanes(tb, page)
            args, sc = split_case(kv, lens, h, hkv, d, page, tb,
                                  seed=400 + i)
            out = PA.paged_decode_attention_cuda(*args, **sc)
            again = PA.paged_decode_attention_cuda(*args, **sc)
            ref = PA.paged_decode_attention_plain(
                args[0].float(), *args[1:], **sc).to(bf16)
            torch.cuda.synchronize()
            live = args[4] > 0
            report(f"decode splits bf16 q, {kv or 'bf16'} pages H={h} "
                   f"Hkv={hkv} D={d} page={page} Tb={tb} seq_lens={lens}",
                   max_err(out[live], ref[live]), ATTN_TOLS[bf16])
            require(out[~live].abs().max().item() == 0.0,
                    "an empty lane is not exactly 0")
            require(torch.equal(out, again), f"two launches of the key-split "
                    f"decode differ ({kv or 'bf16'} pages)")
    print("  key-split decode (bf16, int8, fp8 pages): empty lanes exact "
          "zeros, repeats bit-identical", flush=True)


def split_case(kv, lens, h, hkv, d, page, tb, seed):
    """Decode arguments of bf16 q on ``kv`` pages ("" bf16, else int8 /
    fp8 with their row scales): (args, scale kwargs)."""
    if not kv:
        return decode_inputs(torch.bfloat16, lens, h, hkv, d, page, tb,
                             seed), {}
    q, kp, vp, bt, sl = decode_inputs(torch.float32, lens, h, hkv, d, page,
                                      tb, seed)
    kq, vq, ks, vs = quantize_pools(kp, vp, kv)
    return (q.to(torch.bfloat16), kq, vq, bt, sl), dict(k_scale=ks,
                                                        v_scale=vs)


#: (H, Hkv, D) of one lane over a 768-key table (48 pages of 16: three
#: splits): B x H x splits odd, so the split partials' (m, l) float2s end on
#: an 8-byte boundary (gpt2-1.5b decodes one padded lane at 25 heads)
ALIGN_SHAPES = ((3, 1, 128), (25, 25, 64))
ALIGN_LENS = (768, 600)       # all three splits used


def check_split_alignment(routes=("bf16", "int8", "fp8", "fused")):
    """One lane, an odd number of heads, three key splits: the decode
    kernel on bf16, int8 and fp8 pages and the fused dual route on bf16
    pages, each against its plain version (ATTN_TOLS[bf16]).  The
    combine reads the fp32 accumulators as float4s, so they must start on
    a 16-byte boundary of the workspace: the sizer's total less the
    accumulators is that offset.  A misaligned read is a sticky CUDA
    error: run on a tree that may fault, in a process of its own."""
    from repro_torch.kernels import dual_branch as DB
    from repro_torch.kernels import paged_attention as PA
    bf16, page, tb = torch.bfloat16, 16, 48
    ns = -(-tb * page // PA.split_keys(tb * page))
    for (h, hkv, d), n in itertools.product(ALIGN_SHAPES, ALIGN_LENS):
        parts = ns * 1 * h
        for route in routes:
            kv = "" if route in ("bf16", "fused") else route
            args, sc = split_case(kv, [n], h, hkv, d, page, tb, seed=h + n)
            ws = PA._lib().paged_decode_workspace_bytes(
                1, h, hkv, d, page, tb, 1, PA._KV_TYPES[args[1].dtype])
            acc_at = ws - 4 * parts * d
            ref = PA.paged_decode_attention_plain(
                args[0].float(), *args[1:], **sc).to(bf16)
            if route == "fused":
                g = torch.Generator(device="cuda").manual_seed(n)
                x, ffn = ffn_inputs(g, bf16, "swiglu", 1, 256, 200)
                out, _ = DB.fused_dual_branch_decode_cuda(*args, x, ffn)
            else:
                out = PA.paged_decode_attention_cuda(*args, **sc)
            torch.cuda.synchronize()
            report(f"alignment: {route} H={h} Hkv={hkv} D={d} one lane of "
                   f"{n} keys, {ns} splits ({parts} partials, accumulators "
                   f"at byte {acc_at})", max_err(out, ref),
                   ATTN_TOLS[bf16])
            require(acc_at % 16 == 0, f"the decode accumulators start at "
                    f"byte {acc_at}, not on a 16-byte boundary")
    print(f"  odd B x H x splits: {', '.join(routes)} within tolerance, "
          f"accumulators 16-byte aligned", flush=True)


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
    cases = [(kind, B, f, dict()) for kind in DB.KINDS for B in (3, 8, 11)
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
                a2, y2 = DB.fused_dual_branch_decode_cuda(
                    q, kp, vp, bt, sl, x, ffn, kind=kind)
                require(torch.equal(attn, a2) and torch.equal(y, y2),
                        "two launches of the fused kernel differ")
    check_fused_edges(DB)
    check_fp32_routes(DB)
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


def check_fused_edges(DB):
    """The bf16 fused kernel on the key-split edge lanes (G = 1, 3, 8; D =
    32, 64, 128) beside a small FFN with a ragged tile (Dm 256, F 200): attn
    within ATTN_TOLS[bf16], the empty lane exact zeros, y within one bf16
    ulp, two launches bit-identical."""
    bf16 = torch.bfloat16
    for i, (h, hkv, d, page, tb) in enumerate(SPLIT_EDGE_SHAPES):
        kind = DB.KINDS[i % 3]
        lens = edge_lanes(tb, page)
        att = decode_inputs(bf16, lens, h, hkv, d, page, tb, seed=500 + i)
        g = torch.Generator(device="cuda").manual_seed(600 + i)
        x, ffn = ffn_inputs(g, bf16, kind, len(lens), 256, 200)
        attn, y = DB.fused_dual_branch_decode_cuda(*att, x, ffn, kind=kind)
        a2, y2 = DB.fused_dual_branch_decode_cuda(*att, x, ffn, kind=kind)
        ra, ry = DB.fused_dual_branch_decode_plain(
            *(a.float() for a in att[:3]), *att[3:], x.float(),
            {k: w.float() for k, w in ffn.items()}, kind=kind)
        torch.cuda.synchronize()
        live = att[4] > 0
        ry = ry.to(bf16)
        shape = (f"H={h} Hkv={hkv} D={d} page={page} Tb={tb} {kind} B=8 "
                 f"Dm=256 F=200")
        report(f"fused edges attn {shape}",
               max_err(attn[live], ra.to(bf16)[live]), ATTN_TOLS[bf16])
        report(f"fused edges ffn  {shape}", max_err(y, ry), bf16_ulp(ry))
        require(attn[~live].abs().max().item() == 0.0,
                "an empty lane of the fused kernel is not exactly 0")
        require(torch.equal(attn, a2) and torch.equal(y, y2),
                "two launches of the fused kernel differ")
    print("  fused edges: empty lanes exact zeros, repeats bit-identical",
          flush=True)


def check_fp32_routes(DB):
    """fp32 q, x, weights and pages keep the CUDA-core kernels: under
    torch.profiler an fp32 decode, an fp32-q decode on int8 pages, an fp32
    fused call and an fp32 chunk call run attend_block's
    paged_decode_kernel, dual_branch_kernel and paged_chunk_kernel, not the
    bf16-q routes' split_kernel, dual_tc_kernel or the tensor-core
    attention kernel over chunk items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import paged_attention as PA
    f32 = torch.float32
    att = decode_inputs(f32, [1, 300, 1021], H, HKV, D, PAGE, 128, seed=700)
    kq, vq, ks, vs = quantize_pools(att[1], att[2], "int8")
    q8 = (att[0], kq, vq, *att[3:])
    g = torch.Generator(device="cuda").manual_seed(701)
    x, ffn = ffn_inputs(g, f32, "swiglu", 3, 256, 256)
    chk = chunk_inputs(f32, 128, MAIN_CHUNKS[0][1], H, HKV, D, PAGE, 128,
                       seed=702)

    def calls():
        PA.paged_decode_attention_cuda(*att)
        PA.paged_decode_attention_cuda(*q8, k_scale=ks, v_scale=vs)
        DB.fused_dual_branch_decode_cuda(*att, x, ffn)
        PA.paged_chunk_attention_cuda(*chk)
    calls()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        calls()
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    if not names:
        print("  fp32 routes: not measured (the profiler saw no CUDA "
              "kernels)")
        return
    require("paged_decode_kernel" in names and "dual_branch_kernel" in names
            and "paged_chunk_kernel" in names
            and "paged_decode_kernel<float, signed char" in names
            and "split_kernel" not in names and "dual_tc_kernel" not in names
            and "ChunkItems" not in names,
            f"fp32 calls ran other kernels than attend_block's: {names}")
    print("  fp32 routes: paged_decode_kernel (fp32 pages and int8 pages), "
          "dual_branch_kernel and paged_chunk_kernel (CUDA cores), as "
          "before", flush=True)


#: quantized page storage the scale variants take, by EngineConfig.kv_dtype
KV_NARROW = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def quantize_pools(kp, vp, kv):
    """fp32 pools (P, page, Hkv, D) -> (k, v, k_scale, v_scale) in the
    engine's quantized page format (``attention._quant_rows``)."""
    from repro_torch.models.attention import _quant_rows
    dt = KV_NARROW[kv]
    kq, ks = _quant_rows(kp.float(), dt)
    vq, vs = _quant_rows(vp.float(), dt)
    return kq.to(dt), vq.to(dt), ks.contiguous(), vs.contiguous()


def scale_kernel_phase():
    """The scale variants of the packed, decode and chunk kernels (int8 and
    fp8 pools with fp32 row scales) against their plain versions on the
    same bytes, at the main path's shapes and at small ones (D 32 and 64,
    G 1..4, ragged lengths); the packed kernel also on the edge ticks, and
    bit-identical over two launches with bf16 q.  Returns {label:
    main-shape error in bf16}."""
    from repro_torch.kernels import paged_attention as PA
    phase("kernel vs plain: int8 / fp8 scale variants of the three paged "
          "attention kernels")
    # fp32 q (attend_block): kernel and plain version dequantize the same
    # bytes with the same scales in fp32 (one product per element), then
    # run the unquantized path's fp32 math: 1e-4 holds.  bf16 q: the decode
    # and chunk kernels round only the output (one bf16 ulp: 2e-2 for |o|
    # < 4).  The packed kernel (tensor cores) widens the one-byte values to
    # bf16 exactly, applies the scales in fp32 and carries P . vs into P.V
    # as a bf16 pair (to 2^-17), so it too differs from the plain version
    # by fp32 order and the output's rounding: 2e-2 (one rounding of P . vs,
    # relative 2^-9, would cost a bf16 ulp, 2^-5, where |o| >= 4).
    num_pages, tb = 1024, 128
    packed = [("main", mixed_tick(page=PAGE, num_pages=num_pages, tb=tb),
               H, HKV, D, PAGE, num_pages)]
    for d, page, h, hkv in ((64, 16, 6, 2), (32, 8, 3, 1), (64, 4, 16, 4),
                            (128, 8, 4, 4), (32, 4, 4, 2)):
        packed.append((f"small{d}", mixed_tick(
            page=page, num_pages=256, tb=96 // page * 4, n_prefill=37,
            n_decode=3, decode_pos=90, n_pad=3, seed=d + page), h, hkv, d,
            page, 256))
    for page, g, d in EDGE_SHAPES:
        edge = edge_tick(page)
        packed.append((f"edge{page},{g},{d}", edge, 2 * g, 2, d, page,
                       edge[0].numel() + 1))
    dec = [(H, HKV, D, PAGE, tb, [1, PAGE, tb * PAGE, 1021, 500, 2 * PAGE,
                                  1020, 777])]
    chk = [(H, HKV, D, PAGE, tb, c, lanes) for c, lanes in MAIN_CHUNKS]
    for d, page, h, hkv in ((64, 16, 6, 2), (32, 8, 3, 1), (64, 4, 16, 4),
                            (32, 4, 4, 2)):
        dec.append((h, hkv, d, page, 12, [1, page, 12 * page, 3 * page + 1,
                                          5]))
        chk.append((h, hkv, d, page, 12, 8, ((0, 8), (0, 0), (3, 1), (5, 5),
                                             (9, 0), (2, 8))))
    errs = {}
    for kv in KV_NARROW:
        for dtype in (torch.bfloat16, torch.float32):
            tol = ATTN_TOLS[dtype]
            for i, (tag, tick, h, hkv, d, page, npg) in enumerate(packed):
                bt, tok_slot, tok_pos = (x.cuda() for x in tick[:3])
                q, kp, vp = attention_inputs(torch.float32, tok_slot.numel(),
                                             h, hkv, d, page, npg,
                                             seed=40 + i)
                kq, vq, ks, vs = quantize_pools(kp, vp, kv)
                q = q.to(dtype)
                out = PA.paged_packed_attention_cuda(
                    q, kq, vq, bt, tok_slot, tok_pos, k_scale=ks, v_scale=vs)
                ref = PA.paged_packed_attention_plain(
                    q.float(), kq, vq, bt, tok_slot, tok_pos, k_scale=ks,
                    v_scale=vs).to(dtype)
                torch.cuda.synchronize()
                live = tok_pos >= 0
                require(out[~live].abs().max().item() == 0.0,
                        "padding rows are not exactly 0")
                err = report(f"packed.{kv} {str(dtype):14s} H={h} Hkv={hkv} "
                             f"D={d} page={page} T={tok_slot.numel()}",
                             max_err(out[live], ref[live]), tol)
                if i == 0 and dtype == torch.bfloat16:
                    errs[f"paged_packed_attention.{kv}"] = err
            if dtype == torch.bfloat16:
                for label, t in (
                        ("mixed", packed[0][1]),
                        ("decode", decode_tick(page=PAGE,
                                               num_pages=num_pages, tb=tb))):
                    check_repeat(PA, label, t, H, HKV, D, PAGE, num_pages, kv)
                edge = edge_tick(4)
                check_repeat(PA, "edge", edge, 16, 2, 128, 4,
                             edge[0].numel() + 1, kv)
            for i, (h, hkv, d, page, tbl, lens) in enumerate(dec):
                q, kp, vp, bt, sl = decode_inputs(torch.float32, lens, h, hkv,
                                                  d, page, tbl, seed=60 + i)
                kq, vq, ks, vs = quantize_pools(kp, vp, kv)
                q = q.to(dtype)
                out = PA.paged_decode_attention_cuda(q, kq, vq, bt, sl,
                                                     k_scale=ks, v_scale=vs)
                ref = PA.paged_decode_attention_plain(
                    q.float(), kq, vq, bt, sl, k_scale=ks,
                    v_scale=vs).to(dtype)
                torch.cuda.synchronize()
                err = report(f"decode.{kv} {str(dtype):14s} H={h} Hkv={hkv} "
                             f"D={d} page={page} seq_lens={lens}",
                             max_err(out, ref), tol)
                if i == 0 and dtype == torch.bfloat16:
                    errs[f"paged_decode_attention.{kv}"] = err
            for i, (h, hkv, d, page, tbl, c, lanes) in enumerate(chk):
                q, kp, vp, bt, pos, nv = chunk_inputs(
                    torch.float32, c, lanes, h, hkv, d, page, tbl,
                    seed=80 + i)
                kq, vq, ks, vs = quantize_pools(kp, vp, kv)
                q = q.to(dtype)
                out = PA.paged_chunk_attention_cuda(q, kq, vq, bt, pos, nv,
                                                    k_scale=ks, v_scale=vs)
                ref = PA.paged_chunk_attention_plain(
                    q.float(), kq, vq, bt, pos, nv, k_scale=ks,
                    v_scale=vs).to(dtype)
                torch.cuda.synchronize()
                err = report(f"chunk.{kv}  {str(dtype):14s} H={h} Hkv={hkv} "
                             f"D={d} page={page} C={c} (pos, n_valid)="
                             f"{list(lanes)}, all rows", max_err(out, ref),
                             tol)
                if i == 0 and dtype == torch.bfloat16:
                    errs[f"paged_chunk_attention.{kv}"] = err
    return errs


def page_copy_phase():
    """The page-copy kernel against its plain version on copies of the same
    pools, byte for byte (``torch.equal`` on uint8 views): one pool a
    launch (bf16, int8, fp8 and fp32 scale pools, n = 1 and n = 64,
    repeated src, and a page whose byte size takes the byte path); then
    the cache-wide launch of ``copy_paged_pages`` on llama3.2-3b caches of
    bf16 and of int8 pages with their scales against the plain version leaf
    by leaf, at n = 1, at n = 3 with a repeated src and at more pairs than
    one launch takes, with its launches counted.  Returns 0.0, the error of
    a byte-exact copy."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import model as M
    phase("kernel vs plain: page_copy (byte-exact)")
    g = torch.Generator(device="cuda").manual_seed(21)
    P = 256
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))
    perm = (perm + 1).tolist()
    pairs = {"n=1": ([perm[0]], [perm[1]]),
             "n=64": (perm[:64], perm[64:128]),
             "n=8, repeated src": ([perm[0], perm[1]] * 4, perm[130:138])}
    pools = {
        "bf16 (P, 16, 8, 128)": randn(g, torch.bfloat16, P, PAGE, HKV, D),
        "int8 (P, 16, 8, 128)": (randn(g, torch.float32, P, PAGE, HKV, D)
                                 * 40).clamp(-127, 127).to(torch.int8),
        "fp8 (P, 16, 8, 128)": randn(g, torch.float32, P, PAGE, HKV, D).to(
            torch.float8_e4m3fn),
        "fp32 scales (P, 16)": randn(g, torch.float32, P, PAGE),
        "int8 (P, 3, 5) (byte path)": (randn(g, torch.float32, P, 3, 5)
                                       * 40).clamp(-127, 127).to(
                                           torch.int8),
    }
    for name, pool in pools.items():
        for label, (src, dst) in pairs.items():
            a, b = pool.clone(), pool.clone()
            PA.LAUNCHES["page_copy"] = 0
            PA.page_copy(a, src, dst)
            launched = PA.LAUNCHES["page_copy"]
            PA.copy_pages_plain(b, src, dst)
            torch.cuda.synchronize()
            ok = torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            print(f"  {name} {label}: byte-equal {ok}, {launched} launch",
                  flush=True)
            require(ok and launched == 1, f"page_copy differs from its "
                    f"plain version: {name} {label}")
    cfg = get_config("llama3.2-3b")
    P, cap = 640, PA.COPY_MAX_PAIRS
    over = cap + 44
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(5))
    perm = (perm + 1).tolist()
    cases = {"n=1": ([perm[0]], [perm[1]]),
             "n=3, repeated src": ([perm[0], perm[2], perm[0]], perm[3:6]),
             f"n={over} (above the cap of {cap})": (perm[:over],
                                                   perm[over:2 * over])}
    for kv in ("", "int8"):
        cache = M.init_paged_cache(cfg, P, PAGE, 8, "bfloat16", kv_dtype=kv)
        for part in ("block0", "blocks"):
            for pool in cache[part].values():
                flat = pool.view(torch.uint8)
                flat.copy_(torch.randint(0, 256, flat.shape, generator=g,
                                         device="cuda", dtype=torch.uint8))
        leaves = [(p, False) for p in cache["block0"].values()] \
            + [(p, True) for p in cache["blocks"].values()]
        for label, (src, dst) in cases.items():
            want = [pool.clone() for pool, _ in leaves]
            for w, (_, stacked) in zip(want, leaves):
                PA.copy_pages_plain(w, src, dst, stacked=stacked)
            sig = cache["a1_sig"].clone()
            PA.LAUNCHES["page_copy"] = 0
            M.copy_paged_pages(cache, src, dst)
            launched = PA.LAUNCHES["page_copy"]
            torch.cuda.synchronize()
            ok = all(torch.equal(w.view(torch.uint8), pool.view(torch.uint8))
                     for w, (pool, _) in zip(want, leaves)) \
                and torch.equal(sig, cache["a1_sig"])
            n_launch = -(-len(src) // cap)
            name = f"llama3.2-3b cache, {kv or 'bf16'} pages, " \
                   f"{len(leaves)} pool leaves, {label}"
            print(f"  {name}: byte-equal {ok}, a1_sig untouched; "
                  f"{launched} launch(es), {n_launch} expected", flush=True)
            require(ok and launched == n_launch, f"copy_paged_pages "
                    f"differs from the plain version leaf by leaf: {name}")
        del cache, leaves, want
    torch.cuda.empty_cache()
    return 0.0


def _median_ms(fn, n=100, flush_bytes=256 << 20, lead_cycles=0,
               clean=False):
    """Median over n launches of one launch's CUDA-event time, with the L2
    cache flushed before each launch (the engine finds pages cold: every
    other layer's pages pass through L2 between two reads of a layer).
    The flush writes a 256 MB buffer, so L2 is left full of dirty lines
    that the launch's reads evict and write back; with ``clean`` it reads
    the buffer instead, leaving clean lines (no write-back in the
    interval).  With ``lead_cycles`` the card also spins that many clocks
    after the flush (``torch.cuda._sleep``), so that a wrapper whose host
    work outlasts the flush (about 0.08 ms) adds no idle time between the
    events: the interval is then device time only."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()                                                   # warm-up
    times = []
    for _ in range(n):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _paged_bound_ms(q, kp, kv_rows, score_keys, index_numel, bw, *,
                    extra_bytes=0, extra_flops=0, scale_rows=False):
    """Least time for the work: max(bytes / bandwidth, flops / peak).
    Bytes: ``kv_rows`` K and V rows (Hkv * D each) read once, with their
    two fp32 row scales when ``scale_rows``, q read and the output written
    once, the int32 index arrays, plus ``extra_bytes``; flops: 4 * H * D
    per (query row, visible key), plus ``extra_flops``."""
    h, d = q.shape[-2:]
    row = 2 * kp.shape[2] * d * kp.element_size() + (8 if scale_rows else 0)
    nbytes = (kv_rows * row + 2 * q.numel() * q.element_size()
              + 4 * index_numel + extra_bytes)
    t_bytes = nbytes / bw
    t_ops = (4 * h * d * score_keys + extra_flops) / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bound_ms(q, kp, bt, tok_slot, tok_pos, bw, scale_rows=False):
    """The packed kernel's bound: every slot's key rows up to its furthest
    token, and each token's visible keys."""
    live = tok_pos >= 0
    furthest = {}
    for s, p in zip(tok_slot[live].tolist(), tok_pos[live].tolist()):
        furthest[s] = max(furthest.get(s, -1), p)
    return _paged_bound_ms(q, kp, sum(p + 1 for p in furthest.values()),
                           int((tok_pos[live].long() + 1).sum()),
                           bt.numel() + 2 * tok_slot.numel(), bw,
                           scale_rows=scale_rows)


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
        # the wrapper's host work (~0.06 ms) is close to the flush's: lead
        kernel_ms = _median_ms(lambda: PA.paged_packed_attention_cuda(
            q, kp, vp, bt, tok_slot, tok_pos), lead_cycles=LEAD_CYCLES)
        plain_ms = _median_ms(lambda: PA.paged_packed_attention_plain(
            q, kp, vp, bt, tok_slot, tok_pos), lead_cycles=LEAD_CYCLES)
        # as PR 15 timed it: no lead, so the wrapper's host work may show
        no_lead_ms = _median_ms(lambda: PA.paged_packed_attention_cuda(
            q, kp, vp, bt, tok_slot, tok_pos))
        bound_ms, bound_by = _bound_ms(q, kp, bt, tok_slot, tok_pos,
                                       bw)
        rows[label] = dict(ms=kernel_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           no_lead_ms=no_lead_ms)
        print(f"  {label}: kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) "
              f"library_ms none (no single PyTorch call computes paged "
              f"ragged attention); without the lead {no_lead_ms:.4f}; "
              f"before the tensor-core kernel "
              f"{PACKED_PR15_MS[label.split()[0]]} ms (PERF.md, PR 15's final "
              f"run without a lead, NVIDIA H100 80GB HBM3, 700.00 W)",
              flush=True)
    return rows


#: clocks the card spins before a timed launch whose wrapper's host work is
#: close to the flush's (about 0.2 ms at H100's 1.98 GHz boost clock)
LEAD_CYCLES = 400_000

#: the bf16 packed kernel's times before its tensor-core redesign (PERF.md
#: section 6: attend_block, PR 15's final run), as text beside the new ones
PACKED_PR15_MS = {"decode": "0.1780", "mixed": "0.3039"}
#: the same for the int8 / fp8 packed variants (attend_block, PERF.md
#: section 6)
PACKED_ATTEND_BLOCK_MS = {"int8": "0.2812", "fp8": "0.2831"}


def padded_time_phase(bw):
    """Kernel, plain and bound times of the decode, chunk and fused kernels
    at their main-path shapes (bf16, llama3.2-3b attention, table width
    128); the decode and fused kernels with a lead (and without, as PR 18
    timed them); the fused kernel also beside its two-op route (decode
    kernel + ``mlp_apply`` on cuBLAS), with its FFN blocks alone and its
    attention items alone; the chunk kernel also at two lanes with a long
    history (the key-split side of its route's rule)."""
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
    # the bf16 decode, chunk and fused wrappers size (and allocate) a
    # workspace and (fused) encode tensor maps: host work near the flush's,
    # hence a lead
    lead = {"paged_decode_attention": LEAD_CYCLES,
            "paged_chunk_attention": LEAD_CYCLES,
            "fused_dual_branch_decode": LEAD_CYCLES}
    for name, (shape, kernel, plain, (bound_ms, bound_by)) in cases.items():
        row = dict(shape=shape + ", bf16, H=24 Hkv=8 D=128 page=16 Tb=128",
                   ms=_median_ms(kernel, lead_cycles=lead.get(name, 0)),
                   plain_ms=_median_ms(plain), bound_ms=bound_ms,
                   bound_by=bound_by)
        extra = ""
        if name in lead:
            row["no_lead_ms"] = _median_ms(kernel)
            # the same with a flush that leaves no dirty lines to write back
            row["clean_flush_ms"] = _median_ms(kernel, lead_cycles=LEAD_CYCLES,
                                               clean=True)
            extra = (f" (without the lead {row['no_lead_ms']:.4f}; after a "
                     f"read flush, no write-back, "
                     f"{row['clean_flush_ms']:.4f}; before "
                     f"the redesign {BEFORE_REDESIGN_MS[name]} ms, PERF.md, "
                     f"without a lead, NVIDIA H100 80GB HBM3, 700.00 W)")
        if name == "paged_chunk_attention":
            # the split side of the chunk route's rule (the tick above
            # takes one split): few lanes with a long history
            few = [(1800, 128), (1900, 100)]
            fa = chunk_inputs(bf16, 128, few, H, HKV, D, PAGE, tb, seed=5)
            row["few_lanes_ms"] = _median_ms(
                lambda: PA.paged_chunk_attention_cuda(*fa),
                lead_cycles=LEAD_CYCLES)
            row["few_lanes_bound_ms"] = _paged_bound_ms(
                fa[0], fa[1], sum(chunk_keys(p, n, 127, tb) for p, n in few),
                sum(chunk_keys(p, n, c, tb) for p, n in few
                    for c in range(128)), fa[3].numel() + 4, bw)[0]
            extra += (f"; few lanes, {few} "
                      f"({chunk_route(PA, 2, 128, H, HKV, tb * PAGE)}): "
                      f"kernel_ms {row['few_lanes_ms']:.4f} bound_ms "
                      f"{row['few_lanes_bound_ms']:.4f}")
        if name == "fused_dual_branch_decode":
            row["unfused_ms"] = _median_ms(lambda: (
                PA.paged_decode_attention_cuda(*dec),
                L.mlp_apply(ffn, x[:, None], "swiglu")),
                lead_cycles=LEAD_CYCLES)
            # where its time goes: the same call with one key per lane (the
            # FFN blocks alone), and with a one-tile FFN of Dm = F = 64 (the
            # attention items alone)
            short = (*dec[:4], torch.ones_like(dec[4]))
            row["ffn_alone_ms"] = _median_ms(
                lambda: DB.fused_dual_branch_decode_cuda(*short, x, ffn),
                lead_cycles=LEAD_CYCLES)
            xs, tiny = ffn_inputs(g, bf16, "swiglu", 8, 64, 64)
            row["attn_alone_ms"] = _median_ms(
                lambda: DB.fused_dual_branch_decode_cuda(*dec, xs, tiny),
                lead_cycles=LEAD_CYCLES)
            extra += (f"; unfused_ms {row['unfused_ms']:.4f} (decode kernel "
                      f"+ mlp_apply); FFN blocks alone (1 key per lane) "
                      f"{row['ffn_alone_ms']:.4f}; attention items alone "
                      f"(Dm = F = 64) {row['attn_alone_ms']:.4f}")
        rows[name] = row
        print(f"  {name}, {row['shape']}: kernel_ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} bound_ms {bound_ms:.4f} "
              f"({bound_by}){extra} library_ms none (no single PyTorch call "
              f"computes it)", flush=True)
    return rows


#: the decode, chunk and fused kernels' times before their redesign (PERF.md
#: section 6, in brackets there), as text beside the new ones
BEFORE_REDESIGN_MS = {
    "paged_decode_attention": "0.1781",
    "fused_dual_branch_decode": "0.2504 (FFN blocks alone 0.2466, "
                                "unfused_ms 0.2501)",
    "paged_chunk_attention": "0.8872 (attend_block)",
    "paged_chunk_attention.int8": "0.9320 (attend_block)",
    "paged_chunk_attention.fp8": "0.9301 (attend_block)",
    "paged_decode_attention.int8": "0.1778 (attend_block)",
    "paged_decode_attention.fp8": "0.1896 (attend_block)"}


def scale_time_phase(bw):
    """Kernel, plain and bound times of the six scale variants at the main
    path's shapes (q in bf16, llama3.2-3b attention, page 16): the packed
    kernel on the mixed tick and on the decode-only tick (as the bf16
    pages' row), the decode kernel on 8 lanes x 1021 keys, the chunk kernel
    on 8 lanes x C = 128 at pos 256, each timed with a lead (and the three
    redesigned ones without it as ``no_lead_ms``).  The bound counts the
    narrow K/V bytes plus the two fp32 scales of each key row."""
    from repro_torch.kernels import paged_attention as PA
    phase("kernel time: int8 / fp8 scale variants")
    bf16, tb, rows = torch.bfloat16, 128, {}
    tick = mixed_tick(page=PAGE, num_pages=1024, tb=tb)
    bt_p, tok_slot, tok_pos = (x.cuda() for x in tick[:3])
    qp, kp, vp = attention_inputs(torch.float32, tok_slot.numel(), H, HKV,
                                  D, PAGE, 1024, seed=3)
    dtick = [x.cuda() for x in decode_tick(page=PAGE, num_pages=1024, tb=tb)]
    q_dt = attention_inputs(torch.float32, dtick[1].numel(), H, HKV, D, PAGE,
                            1024, seed=3)[0].to(bf16)
    lens = [1021] * 8
    dec = decode_inputs(torch.float32, lens, H, HKV, D, PAGE, tb, seed=3)
    lanes = [(256, n) for n in (128, 128, 44, 128, 100, 128, 0, 128)]
    chk = chunk_inputs(torch.float32, 128, lanes, H, HKV, D, PAGE, tb,
                       seed=4)
    keys = sum(lens)
    for kv in KV_NARROW:
        pk = quantize_pools(kp, vp, kv)
        dk = quantize_pools(dec[1], dec[2], kv)
        ck = quantize_pools(chk[1], chk[2], kv)
        sc = lambda t: dict(k_scale=t[2], v_scale=t[3])  # noqa: E731
        q_p, q_d, q_c = qp.to(bf16), dec[0].to(bf16), chk[0].to(bf16)
        cases = {
            "paged_packed_attention": (
                "mixed tick (256 prefill + 7 decode near 1024 + 9 pad)",
                lambda: PA.paged_packed_attention_cuda(
                    q_p, pk[0], pk[1], bt_p, tok_slot, tok_pos, **sc(pk)),
                lambda: PA.paged_packed_attention_plain(
                    q_p, pk[0], pk[1], bt_p, tok_slot, tok_pos, **sc(pk)),
                _bound_ms(q_p, pk[0], bt_p, tok_slot, tok_pos, bw,
                          scale_rows=True)),
            "paged_decode_attention": (
                "decode tick: 8 lanes x 1021 keys",
                lambda: PA.paged_decode_attention_cuda(
                    q_d, dk[0], dk[1], dec[3], dec[4], **sc(dk)),
                lambda: PA.paged_decode_attention_plain(
                    q_d, dk[0], dk[1], dec[3], dec[4], **sc(dk)),
                _paged_bound_ms(q_d, dk[0], keys, keys, dec[3].numel() + 8,
                                bw, scale_rows=True)),
            "paged_chunk_attention": (
                f"chunk tick: 8 lanes x C=128 at pos 256, n_valid "
                f"{[n for _, n in lanes]}",
                lambda: PA.paged_chunk_attention_cuda(
                    q_c, ck[0], ck[1], *chk[3:], **sc(ck)),
                lambda: PA.paged_chunk_attention_plain(
                    q_c, ck[0], ck[1], *chk[3:], **sc(ck)),
                _paged_bound_ms(
                    q_c, ck[0],
                    sum(chunk_keys(p, n, 127, tb) for p, n in lanes),
                    sum(chunk_keys(p, n, c, tb) for p, n in lanes
                        for c in range(128)), chk[3].numel() + 16, bw,
                    scale_rows=True)),
        }
        for name, (shape, kernel, plain, (bound_ms, bound_by)) in \
                cases.items():
            label = f"{name}.{kv}"
            # the wrappers' host work (workspace, ~0.06 ms) is close to
            # the flush's: lead, as for bf16 pages
            lead = LEAD_CYCLES
            row = dict(shape=f"{shape}, q bf16, {kv} pages + fp32 row "
                       f"scales, H=24 Hkv=8 D=128 page=16 Tb=128",
                       ms=_median_ms(kernel, lead_cycles=lead),
                       plain_ms=_median_ms(plain, lead_cycles=lead),
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=None)
            extra = ""
            if name in ("paged_chunk_attention", "paged_decode_attention"):
                row["no_lead_ms"] = _median_ms(kernel)
                extra = (f"; without the lead {row['no_lead_ms']:.4f}; "
                         f"before the redesign {BEFORE_REDESIGN_MS[label]} "
                         f"ms (PERF.md, without a lead, NVIDIA H100 80GB "
                         f"HBM3, 700.00 W)")
            if name == "paged_packed_attention":
                row["no_lead_ms"] = _median_ms(kernel)
                dk_args = (q_dt, pk[0], pk[1], *dtick)
                row["decode_tick_ms"] = _median_ms(
                    lambda: PA.paged_packed_attention_cuda(*dk_args,
                                                           **sc(pk)),
                    lead_cycles=lead)
                row["decode_tick_bound_ms"] = _bound_ms(
                    q_dt, pk[0], *dtick, bw, scale_rows=True)[0]
                extra = (f"; without the lead {row['no_lead_ms']:.4f}; "
                         f"decode tick (8 tokens x ~64 pages) kernel_ms "
                         f"{row['decode_tick_ms']:.4f} bound_ms "
                         f"{row['decode_tick_bound_ms']:.4f}; attend_block "
                         f"before: {PACKED_ATTEND_BLOCK_MS[kv]} ms mixed "
                         f"tick (PERF.md section 6, without a lead, NVIDIA "
                         f"H100 80GB HBM3, 700.00 W)")
            rows[label] = row
            print(f"  {label}, {row['shape']}: kernel_ms {row['ms']:.4f} "
                  f"plain_ms {row['plain_ms']:.4f} bound_ms {bound_ms:.4f} "
                  f"({bound_by}) library_ms none (no single PyTorch call "
                  f"computes it){extra}", flush=True)
    return rows


def page_copy_time_phase(bw):
    """Time of one copy-on-write at llama3.2-3b (one page across all 28
    layers: block 0's pools and the stacked (27, P, ...) pools; 4 pool
    leaves in bf16, 8 with int8 pages and their scales), and of 64 pages:
    the kernel (one launch for the whole cache, page ids from host lists in
    its parameters) with a lead (device time) and without, the PyTorch call
    ``pool.index_copy_(0, dst, pool.index_select(0, src))`` per leaf on ids
    already on the card (the stacked leaves as flat pages with per-layer
    ids), the plain version, and ``copy_paged_pages`` as the engine calls
    it (host page lists, checked once: ``wrapper_ms``, no lead), with the
    launches of one kernel call, counted.  The bound is 2 x the bytes
    copied (read once, written once) at the card's memory rate."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import model as M
    phase("kernel time: page_copy (one COW at llama3.2-3b, and 64 pages)")
    cfg = get_config("llama3.2-3b")
    rows = {}
    for kv in ("", "int8"):
        P = 256
        cache = M.init_paged_cache(cfg, P, PAGE, 8, "bfloat16", kv_dtype=kv)
        leaves = [(p, False) for p in cache["block0"].values()] \
            + [(p, True) for p in cache["blocks"].values()]
        for n in (1, 64):
            src, dst = list(range(1, 1 + n)), list(range(100, 100 + n))
            flat = []
            for pool, stacked in leaves:
                layers = pool.shape[0] if stacked else 1
                ids = torch.tensor(
                    [[s + i * P for i in range(layers) for s in src],
                     [d + i * P for i in range(layers) for d in dst]],
                    dtype=torch.long, device="cuda")
                flat.append((pool.view((layers * P,)
                                       + tuple(pool.shape[1 + stacked:])),
                             ids))
            nbytes = sum(ids.shape[1] * pool.numel() // pool.shape[0]
                         * pool.element_size() for pool, ids in flat)

            def kernel():
                PA.page_copy_cuda(leaves, src, dst)

            def library():
                for pool, i in flat:
                    pool.index_copy_(0, i[1], pool.index_select(0, i[0]))

            def plain():
                for pool, stacked in leaves:
                    PA.copy_pages_plain(pool, src, dst, stacked=stacked)

            PA.LAUNCHES["page_copy"] = 0
            kernel()
            launches_a_call = PA.LAUNCHES["page_copy"]
            require(launches_a_call == -(-n // PA.COPY_MAX_PAIRS),
                    f"page_copy: {launches_a_call} launches for {n} pairs")
            label = (f"{'int8 pages + scales' if kv else 'bf16'}, {n} "
                     f"page{'s' if n > 1 else ''} x 28 layers, "
                     f"{len(leaves)} pool leaves")
            row = dict(
                shape=label, ms=_median_ms(kernel, lead_cycles=LEAD_CYCLES),
                no_lead_ms=_median_ms(kernel),
                wrapper_ms=_median_ms(
                    lambda: M.copy_paged_pages(cache, src, dst)),
                plain_ms=_median_ms(plain), library_ms=_median_ms(library),
                bound_ms=2 * nbytes / bw * 1e3, bound_by="bytes",
                launches_a_call=launches_a_call)
            rows[label] = row
            print(f"  {label}: {nbytes} bytes; kernel_ms {row['ms']:.4f} "
                  f"({launches_a_call} launch a call; without the lead "
                  f"{row['no_lead_ms']:.4f}) "
                  f"library_ms {row['library_ms']:.4f} (index_copy_ + "
                  f"index_select per leaf) bound_ms {row['bound_ms']:.4f} "
                  f"(bytes); plain_ms {row['plain_ms']:.4f}; wrapper_ms "
                  f"{row['wrapper_ms']:.4f} (copy_paged_pages from host "
                  f"page lists); before the redesign "
                  f"{COPY_BEFORE_MS.get((kv, n), 'not measured')} (PERF.md)",
                  flush=True)
        del cache, leaves, flat
    return rows


#: page_copy before its redesign (PERF.md section 6: the last final run
#: of the per-leaf kernel, one launch a leaf, no lead; NVIDIA H100 80GB
#: HBM3, 700.00 W): kernel_ms / wrapper_ms, as text beside the new times
COPY_BEFORE_MS = {("", 1): "0.0758 / 0.2199", ("", 64): "0.0978 / 1.778",
                  ("int8", 1): "0.0798 / 0.6507",
                  ("int8", 64): "0.2025 / 3.5669"}


def random_history(cache, g):
    """Fill every pool (K / V, or MLA's latent c and rope key kr) and the
    per-slot a1_sig with N(0, 1); quantized pools get the N(0, 1) rows'
    codes and row scales."""
    from repro_torch.models.attention import _quant_rows
    for pools in (cache["block0"], cache["blocks"]):
        for name in [n for n in pools if not n.endswith("_scale")]:
            x = torch.randn(pools[name].shape, generator=g)
            if f"{name}_scale" in pools:
                x, sc = _quant_rows(x, pools[name].dtype)
                pools[f"{name}_scale"].copy_(sc)
            pools[name].copy_(x.to(pools[name].dtype))
    cache["a1_sig"].copy_(torch.randn(cache["a1_sig"].shape, generator=g))


def tick_phase():
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = get_config("llama3.2-3b").replace(n_layers=2, dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    packed_tick(cfg, params)
    for kv in KV_NARROW:
        packed_tick(cfg, params, kv)
    spec_tick(cfg, params)
    cuda = ops.CUDA
    padded_tick(cfg, params, "chunk tick C=128", 128,
                ((0, 128), (128, 128), (256, 37), (300, 0), (0, 1),
                 (64, 128), (200, 90), (500, 128)), 40, False,
                {"paged_chunk_attention": cuda, "fused_ln_add": cuda})
    counts = padded_tick(
        cfg, params, "dual-branch decode tick C=1", 1,
        ((0, 1), (15, 1), (16, 1), (300, 1), (511, 1), (100, 0), (200, 1),
         (63, 1)), 64, True,
        {"paged_decode_attention": cuda, "dual_branch_decode": cuda,
         "fused_ln_add": cuda})
    require(counts["fused_dual_branch_decode"] == 1
            and counts["paged_decode_attention"] == 1,
            f"dual tick did not run block 0 on the decode kernel and block "
            f"1 on the fused kernel: {counts}")


def padded_tick(cfg, params, label, C, lanes, tb, dual, want_paths,
                scaled_tol=False, moe=False, image=False):
    """One padded (B, C) tick at per-lane (pos, n_valid) over a random
    history: the card (kernels) against the CPU (plain versions).  Returns
    the card run's launch counts.  ``scaled_tol``: the tolerance is 1e-3
    times max(1, the largest |hidden|) (fp32 sums in another order, errors
    relative to the activations' size).  ``moe``: the routing of both runs
    is compared (``route_flips``); a lane whose routing differs at a near
    tie is left out of the gate.  ``image``: each row carries a random
    patch embedding (a VLM's rows inside its image prefix take it)."""
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
    if image:
        batch["image_embeds"] = torch.randn((B, C, cfg.d_model), generator=g)
    plan = ExecutionPlan.single_device("paged", dual_branch=dual)
    gpu = {k: interop.tree_to(v, "cuda") for k, v in
           (("params", params), ("cache", cache), ("batch", batch))}
    ops.reset_dispatch_paths()
    ops.reset_launches()
    with routes_if(moe) as routes, torch.no_grad():
        h_gpu, c_gpu = M.paged_decode_step(gpu["params"], cfg, gpu["batch"],
                                           gpu["cache"], plan, want="hidden")
        torch.cuda.synchronize()
        paths, counts = ops.dispatch_paths(), ops.launch_counts()
        h_cpu, c_cpu = M.paged_decode_step(params, cfg, batch, cache, plan,
                                           want="hidden")
    live = torch.arange(C)[None] < n_valid[:, None]               # (B, C)
    kept = torch.ones(B, dtype=torch.bool)
    if moe:                     # an MoE call's row b * C + c is lane b's
        for lane in {r // C for _, r, _ in route_flips(routes, label)}:
            kept[lane] = False
        live &= kept[:, None]
    dh = (h_gpu.cpu()[live] - h_cpu[live]).abs().max().item()
    ds = (c_gpu["a1_sig"].cpu() - c_cpu["a1_sig"])[kept].abs().max().item()
    top = h_cpu[live].abs().max().item()
    tol = 1e-3 * max(1.0, top) if scaled_tol else 1e-3
    print(f"  (pos, n_valid) {list(lanes)}, Tb={tb}: hidden max |diff| "
          f"{dh:.3e} (max |h| {top:.3f}); a1_sig max |diff| {ds:.3e}; tol "
          f"{tol:.3g} (fp32 on both sides, sums in another order"
          f"{', 1e-3 x max |h|' if scaled_tol else ', activations of order 1'}"
          f"); card paths {paths}; launches {counts}", flush=True)
    require(paths == want_paths, f"card tick paths {paths} != {want_paths}")
    require(dh <= tol and ds <= tol,
            "card tick disagrees with the CPU plain path")
    require(bool(torch.isfinite(h_gpu).all()),
            "non-finite hidden states on the card")
    return counts


#: near-tie bounds on the router's probabilities: a token may choose other
#: experts in two runs (the card and the CPU, or a sharded run and one
#: device) only where the reference run's k-th and (k+1)-th largest
#: probabilities lie closer than this fraction of the k-th.  fp32: the
#: router logits of two runs differ by ~1e-6 relative, so 1e-3 leaves three
#: orders of margin and still calls anything wider a fault.  bf16: the
#: logits are bf16 (|logit| < 4 at these scales, one ulp <= 2^-6), and one
#: ulp on each of two logits moves their probabilities' ratio by up to
#: 2^-5; 2^-4 leaves a factor of two
MOE_GAP_EPS = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -4}


def routes_if(on):
    """``moe.recording_routes()`` when ``on``, else an empty stand-in."""
    import contextlib
    from repro_torch.models import moe as MO
    return MO.recording_routes() if on else contextlib.nullcontext([])


def route_flips(records, label, ref=None, eps=MOE_GAP_EPS[torch.float32],
                what="card vs CPU"):
    """``records``: ``moe.recording_routes``'s list over a run, compared
    call by call with ``ref``'s (the reference run's); without ``ref``,
    ``records`` holds a card run and then the same run on the CPU, and its
    second half is the reference.  Prints how many (token, slot) choices
    differ and, at each token that differs, the reference's probability gap
    between its k-th and (k+1)-th expert relative to the k-th; fails where
    a gap is not below ``eps``.  Returns [(call, row, gap)] of the rows
    that differ."""
    if ref is None:
        half = len(records) // 2
        require(half > 0 and len(records) == 2 * half,
                f"{label}: {len(records)} routing records, not two equal "
                f"runs")
        records, ref = records[:half], records[half:]
    require(len(records) == len(ref) > 0,
            f"{label}: {len(records)} routing records against {len(ref)}")
    flips, n_slots, n_rows = [], 0, 0
    for i, ((e_a, _), (e_b, p_b)) in enumerate(zip(records, ref)):
        e_a, e_b, p_b = e_a.cpu(), e_b.cpu(), p_b.float().cpu()
        k = e_b.shape[-1]
        same = (e_a[:, :, None] == e_b[:, None, :]).any(-1).sum(-1)
        top = p_b.topk(k + 1, dim=-1).values
        gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        n_slots += int((k - same).sum())
        n_rows += e_b.shape[0]
        for r in (same < k).nonzero()[:, 0].tolist():
            flips.append((i, r, float(gap[r])))
    far = [f for f in flips if f[2] >= eps]
    print(f"  routing {what} ({label}): {n_slots} (token, slot) choices "
          f"differ, at {len(flips)} of {n_rows} token-layers; relative "
          f"probability gaps there {[f'{g:.2e}' for _, _, g in flips[:8]]} "
          f"(allowed below {eps:g}: a near tie)", flush=True)
    require(not far, f"{label}: routing differs where the router's "
            f"probabilities do not tie: {far[:5]}")
    return flips


#: card vs CPU tolerance on a packed tick's hidden states and a1_sig: fp32
#: on both sides, sums in another order, activations of order 1 -> 1e-3.
#: On quantized pages the tick's new K/V rows are quantized on each side
#: from its own fp32 projections, so a value within ~1e-6 of a rounding
#: boundary can take the neighbouring code there: one step is 1/127 (int8)
#: or one e4m3 ulp of the row's largest element, weighted by a softmax
#: probability and the output projection -> 1e-2.
TICK_TOLS = {"": 1e-3, "int8": 1e-2, "fp8": 1e-2}


def packed_tick(cfg, params, kv="", want_paths=None, scaled_tol=False,
                moe=False, image=False):
    """One packed tick (``mixed_tick``) over a random history, the card
    against the CPU; ``want_paths``: the card's dispatch paths (default:
    the packed kernel's site and the LN-add kernel); ``scaled_tol`` and
    ``moe`` as in ``padded_tick`` (a slot whose routing differs at a near
    tie is left out of the gate); ``image``: every row carries a random
    patch embedding (a VLM's rows inside its image prefix take it).
    Returns the card run's launch counts."""
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    phase(f"one packed tick of {cfg.arch_id} at full width"
          f"{', ' + kv + ' pages' if kv else ''}: card (kernel) vs CPU "
          f"(plain)")
    num_pages, tb = 512, 72
    bt, tok_slot, tok_pos, seg_last = mixed_tick(
        page=PAGE, num_pages=num_pages, tb=tb, seed=5)
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, tok_slot.shape, generator=g,
                           dtype=torch.int32)
    batch = dict(tokens=tokens, tok_slot=tok_slot, tok_pos=tok_pos,
                 block_tables=bt, seg_last=seg_last)
    cache = M.init_paged_cache(cfg, num_pages, PAGE, seg_last.numel(),
                               "float32", kv_dtype=kv, device="cpu")
    random_history(cache, g)
    if image:
        batch["image_embeds"] = torch.randn((len(tokens), cfg.d_model),
                                            generator=g)
    gpu = {k: interop.tree_to(v, "cuda") for k, v in
           (("params", params), ("cache", cache), ("batch", batch))}
    ops.reset_dispatch_paths()
    ops.reset_launches()
    with routes_if(moe) as routes, torch.no_grad():
        h_gpu, c_gpu = M.paged_decode_step(gpu["params"], cfg, gpu["batch"],
                                           gpu["cache"], want="hidden")
        torch.cuda.synchronize()
        paths_gpu, counts = ops.dispatch_paths(), ops.launch_counts()
        h_cpu, c_cpu = M.paged_decode_step(params, cfg, batch, cache,
                                           want="hidden")
    live = tok_pos >= 0
    kept = torch.ones(seg_last.numel(), dtype=torch.bool)
    if moe:                     # an MoE call's row t is packed token t
        for slot in {int(tok_slot[r]) for _, r, _ in
                     route_flips(routes, f"packed tick of {cfg.arch_id}")}:
            kept[slot] = False
        live &= kept[tok_slot.long()]
    dh = (h_gpu[0, live.cuda()].cpu() - h_cpu[0, live]).abs().max().item()
    ds = (c_gpu["a1_sig"].cpu() - c_cpu["a1_sig"])[kept].abs().max().item()
    scale = h_cpu[0, live].abs().max().item()
    tol = TICK_TOLS[kv] * (max(1.0, scale) if scaled_tol else 1.0)
    codes = ""
    if kv:
        diff = sum(int((c_gpu[part][n].cpu().view(torch.uint8)
                        != c_cpu[part][n].view(torch.uint8)).sum())
                   for part in ("block0", "blocks") for n in ("k", "v"))
        codes = f"; K/V codes that differ card vs CPU: {diff}"
    print(f"  hidden max |diff| {dh:.3e} (max |h| {scale:.3f}); a1_sig max "
          f"|diff| {ds:.3e}; tol {tol:.3g} (TICK_TOLS"
          f"{' x max |h|' if scaled_tol else ''}){codes}; card path "
          f"{paths_gpu}", flush=True)
    site = "paged_packed_attention" + (f".{kv}" if kv else "")
    want_paths = want_paths or {site: ops.CUDA, "fused_ln_add": ops.CUDA}
    if paths_gpu != want_paths:
        raise AssertionError(f"card tick did not run the kernel: {paths_gpu}")
    if not (dh <= tol and ds <= tol):
        raise AssertionError("card tick disagrees with the CPU plain path")
    if not torch.isfinite(h_gpu).all():
        raise AssertionError("non-finite hidden states on the card")
    return counts


def spec_tick(cfg, params):
    """One speculative tick (``make_spec_step``, spec_tokens=4,
    draft_blocks=1) at full width from one cache state, on the card
    (kernels) and on the CPU (plain versions): the verify layout of
    ``spec_ticks`` (six lanes speculating, two plain decode lanes, a
    prefill lane, padding), greedy.  The draft logits of each iteration and
    the verify logits are compared on the rows whose fed tokens (the
    proposals so far) agree on both sides, within TICK_TOLS[""]; the card
    runs the verify and .draft sites on the kernels, (2 + 3 x 1) launches
    of each."""
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve import sampling as SP
    from repro_torch.serve.scheduler import make_spec_step
    phase("one speculative tick at full width (spec_tokens=4, draft_blocks"
          "=1): card (kernel) vs CPU (plain)")
    n, num_pages, tb = 4, 512, 72
    (bt, tok_slot, tok_pos), _ = spec_ticks(page=PAGE, num_pages=num_pages,
                                             tb=tb, n=n)
    S = bt.shape[0]
    seg_last = torch.tensor([int((tok_slot == s).nonzero().max())
                             for s in range(S)], dtype=torch.int32)
    spec_mask = torch.tensor(list(SPEC_LANES) + [False])
    g = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, cfg.vocab, tok_slot.shape, generator=g,
                           dtype=torch.int32)
    cache = M.init_paged_cache(cfg, num_pages, PAGE, S, "float32",
                               device="cpu")
    random_history(cache, g)
    z = torch.zeros(S, dtype=torch.int32)
    batch = (tokens, tok_slot, tok_pos, bt, seg_last, spec_mask,
             torch.zeros(S), z, torch.ones(S), z)
    seen = {}

    def run(device, p, c, args):
        logits = seen.setdefault(device, [])

        def record(lg, *a):
            logits.append(lg.float().cpu())
            return SP.greedy(lg)
        step = make_spec_step(cfg, spec_tokens=n, draft_blocks=1,
                              sampler=record)
        tgt, fed, _ = step(p, c, *args)
        return tgt.cpu(), fed.cpu()

    gpu = {k: interop.tree_to(v, "cuda") for k, v in
           (("params", params), ("cache", cache))}
    ops.reset_dispatch_paths()
    ops.reset_launches()
    tgt_g, fed_g = run("cuda", gpu["params"], gpu["cache"],
                       [a.cuda() for a in batch])
    torch.cuda.synchronize()
    paths, counts = ops.dispatch_paths(), ops.launch_counts()
    tgt_c, fed_c = run("cpu", params, cache, batch)
    agree = (fed_g == fed_c).long().cumprod(-1).bool()          # (S, n)
    draft_diff, rows = 0.0, 0
    for j in range(n - 1):          # iteration j reads rows 0..j of a lane
        ok = spec_mask & agree[:, j]
        rows += int(ok.sum())
        draft_diff = max(draft_diff, (seen["cuda"][j][ok]
                                      - seen["cpu"][j][ok]).abs().max()
                         .item())
    live = fed_c >= 0
    vg, vc = (seen[d][n - 1].reshape(S, n, -1) for d in ("cuda", "cpu"))
    vrows = agree & live
    verify_diff = (vg[vrows] - vc[vrows]).abs().max().item()
    tol = TICK_TOLS[""]
    print(f"  fed tokens agree on {int(vrows.sum())}/{int(live.sum())} live "
          f"verify rows; draft logits max |diff| {draft_diff:.3e} over "
          f"{rows} lane-iterations, verify logits max |diff| "
          f"{verify_diff:.3e} (max |logit| {vc[vrows].abs().max().item():.3f}"
          f"); tol {tol:g}; targets equal on "
          f"{int(((tgt_g == tgt_c) & vrows).sum())} of them; card paths "
          f"{paths}; launches {counts}", flush=True)
    require(paths == {s: ops.CUDA for s in (
        "paged_packed_attention", "fused_ln_add",
        "paged_packed_attention.draft", "fused_ln_add.draft")},
        f"card spec tick paths {paths}")
    require(counts["paged_packed_attention"] == 2 + (n - 1)
            and counts["fused_ln_add"] == 2 + (n - 1),
            f"spec tick launches {counts} != 2 layers + 3 draft x 1")
    require(rows > 0 and int(vrows.sum()) > int(live.sum()) // 2,
            "too few rows agree to compare")
    require(draft_diff <= tol and verify_diff <= tol,
            "card spec tick disagrees with the CPU plain path")


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
    step_for = engine._step_for

    def checked_step_for(kind):
        inner = step_for(kind)

        def checked(*args):
            logits, nxt, cache = inner(*args)
            nan_seen.append(torch.isnan(logits).any())
            return logits, nxt, cache
        return checked

    engine._step_for = checked_step_for
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
    # fal: one fused_ln_add per layer per tick (block 0's ln2(x) + ln_a(a),
    # each later block's ln2(x) + a1_sig)
    ln_adds = counts["fused_ln_add"]
    print(f"  fused_ln_add launches {ln_adds} (ticks x layers)", flush=True)
    if launches != st["ticks"] * cfg.n_layers or ln_adds != launches \
            or st["packed_calls"] != st["ticks"] or sum(counts.values()) \
            != launches + ln_adds:
        raise AssertionError(f"kernel launches != ticks x layers: {counts}")
    if paths != {"paged_packed_attention": ops.CUDA,
                 "fused_ln_add": ops.CUDA}:
        raise AssertionError(f"engine did not run the kernel only: {paths}")
    bf16_page = cfg.n_layers * 2 * PAGE * HKV * D * 2
    print(f"  page_bytes {st['pages']['page_bytes']} (28 layers x K and V x "
          f"16 x 8 x 128 bf16 = {bf16_page})", flush=True)
    require(st["pages"]["page_bytes"] == bf16_page, "bf16 page_bytes")
    prompts, streams = profile_phase(engine, cfg, rng)
    del engine
    torch.cuda.empty_cache()
    dual_engine_phase(cfg, params, ecfg, prompts, streams)
    return launches, dict(ticks=st["ticks"], tok_s=gen / wall,
                          wall_s=wall), params, ecfg, prompts, streams


#: the profile workload's ticks run under torch.profiler (the first ones:
#: its 1,600 prompt tokens' prefill ticks and the first decode ticks); the
#: profiler's processing of all ~31 ticks took most of this phase's ~50 s
PROFILE_WINDOW = 10


def profile_phase(engine, cfg, rng):
    """Where a tick's time goes, after the counted run: the same second
    workload (8 requests of 200 prompt tokens, 24 new tokens each) is served
    twice by the same engine, first plainly for the wall time, then with
    its first PROFILE_WINDOW ticks under torch.profiler for the device time
    (the sum of the CUDA kernels' own times).  Busy share = device time /
    the unprofiled wall time of the same ticks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.scheduler import ServeRequest
    phase(f"profile: 8 requests x (200 prompt + 24 new), its first "
          f"{PROFILE_WINDOW} ticks under torch.profiler")
    prompts = [rng.integers(0, cfg.vocab, 200) for _ in range(8)]

    def serve(prof=None):
        """-> (wall ms of the first PROFILE_WINDOW ticks, of all, ticks,
        streams); the first ticks under ``prof`` when given."""
        engine.finished.clear()
        for i, p in enumerate(prompts):
            engine.submit(ServeRequest(rid=100 + i, prompt=p, max_new=24))
        t0 = engine.ticks
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        with prof or contextlib.nullcontext():
            for _ in range(PROFILE_WINDOW):
                engine.step()
            torch.cuda.synchronize()
        window_ms = (time.perf_counter() - w0) * 1e3
        engine.run()
        torch.cuda.synchronize()
        streams = {r.rid: list(map(int, r.generated))
                   for r in engine.finished}
        return (window_ms, (time.perf_counter() - w0) * 1e3,
                engine.ticks - t0, streams)

    window_ms, wall_ms, ticks, streams = serve()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, prof_wall_ms, prof_ticks, _ = serve(prof)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(ms for _, ms, _ in rows)
    attn_ms = sum(ms for k, ms, _ in rows if "paged_packed_kernel" in k
                  or "packed_tc::" in k)
    n = PROFILE_WINDOW
    print(f"  unprofiled: {ticks} ticks in {wall_ms:.1f} ms "
          f"({wall_ms / ticks:.2f} ms/tick), the first {n} in "
          f"{window_ms:.1f} ms ({window_ms / n:.2f} ms/tick); with the "
          f"profiler: {prof_ticks} ticks in {prof_wall_ms:.1f} ms")
    if device_ms == 0.0 or prof_ticks != ticks:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels, or the two runs differ)")
        return prompts, streams
    busy = device_ms / window_ms
    print(f"  device kernel time {device_ms:.1f} ms over the first {n} "
          f"ticks ({device_ms / n:.2f} ms/tick): busy share {busy:.3f}, idle "
          f"share {1 - busy:.3f} of their unprofiled wall; "
          f"paged_packed_attention {attn_ms:.2f} ms = "
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
            and counts["fused_ln_add"] == ticks * cfg.n_layers
            and sum(counts.values()) == 2 * ticks * cfg.n_layers,
            f"dual engine launches != ticks x layers: {counts}")
    require(paths == {"paged_packed_attention": ops.CUDA,
                      "fused_ln_add": ops.CUDA},
            f"dual engine did not run the kernel only: {paths}")


def prefix_workload(vocab, page, n_requests=16, seed=7, rate=1.0,
                    sys_pages=4, tail_lo=8, tail_hi=17, full_every=5):
    """The repeated-prefix workload of ``benchmarks/bench_serving.py:155``
    (``_prefix_workload``, its defaults), rebuilt here: request 0 is a cold
    donor (the system prompt + 12 tokens, 4 new) that finishes before
    anyone else arrives; the rest arrive Poisson (1 per tick) after tick 16
    with the system prompt + 8..16 tokens, every 5th repeating the system
    prompt verbatim, and 8..16 new tokens each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, vocab, sys_pages * page)
    work = [{"rid": 0, "arrival_tick": 0,
             "prompt": np.concatenate([sysp, rng.integers(0, vocab, 12)]),
             "max_new": 4}]
    arrivals = 16 + np.cumsum(
        rng.exponential(1.0 / rate, n_requests - 1)).astype(int)
    for i in range(1, n_requests):
        prompt = (sysp.copy() if i % full_every == 0 else
                  np.concatenate([sysp, rng.integers(
                      0, vocab, int(rng.integers(tail_lo, tail_hi)))]))
        work.append({"rid": i, "arrival_tick": int(arrivals[i - 1]),
                     "prompt": prompt,
                     "max_new": int(rng.integers(8, 17))})
    return work


def drive(engine, work):
    """Submit each request at its arrival tick and step the engine until
    every request has finished (``bench_serving._drive``).  Returns the
    wall seconds, the card synchronised at both ends."""
    from repro_torch.serve.scheduler import ServeRequest
    pending = list(work)
    tick = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy = lambda: any(s is not None for s in engine.slots) \
        or engine.queue  # noqa: E731
    while pending or busy():
        for w in list(pending):
            if w["arrival_tick"] <= tick:
                engine.submit(ServeRequest(rid=w["rid"], prompt=w["prompt"],
                                           max_new=w["max_new"]))
                pending.remove(w)
        if busy():
            engine.step()
        tick += 1
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def first_token_probe(engine):
    """Wrap the engine's step and token intake to keep, per request, the
    logits its first token was sampled from (as fp32 on the host) and its
    time to first token in ms."""
    last, firsts = {}, {}
    step_for, consume = engine._step_for, engine._consume_one

    def probed_step_for(kind):
        step = step_for(kind)

        def step_fn(*args):
            logits, nxt, cache = step(*args)
            last["logits"] = logits
            return logits, nxt, cache
        return step_fn

    def consume_one(i, tok, now):
        r = engine.slots[i]
        if not r.generated:
            firsts[r.rid] = (last["logits"][i].float().cpu(),
                             (now - r.submit_time) * 1e3)
        consume(i, tok, now)

    engine._step_for, engine._consume_one = probed_step_for, consume_one
    return firsts


def prefix_engine_phase(cfg, params, ecfg, kv=""):
    """The repeated-prefix workload at llama3.2-3b full width and depth,
    cold (no prefix cache) and hot (``prefix_cache=True``) on ``kv``
    pages.  Hit rate, hot prefill tokens and COW copies are functions of
    the prompts alone, and are gated exactly; the first-token logits of
    every hit request must lie within DUAL_LOGIT_BOUND of the cold run's
    (a hit skips prefill, so its tokens meet cuBLAS at other shapes).
    Returns {kernel label: launches in the hot run}."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import PagedEngine, ServeRequest
    L = cfg.n_layers
    sfx = f".{kv}" if kv else ""
    phase(f"prefix engine: llama3.2-3b, {L} layers, bf16, "
          f"{kv + ' pages' if kv else 'bf16 pages'}, the repeated-prefix "
          f"workload, cold then hot")
    work = prefix_workload(cfg.vocab, ecfg.page_size)
    out = {}
    for name, on in (("cold", False), ("hot", True)):
        engine = PagedEngine(cfg, params, dataclasses.replace(
            ecfg, kv_dtype=kv, prefix_cache=on))
        # warm-up request (allocator pools), outside the counts; its parked
        # prefix is dropped so the tree starts empty
        engine.submit(ServeRequest(rid=-1, prompt=work[0]["prompt"][::-1]
                                   .copy(), max_new=4))
        engine.run()
        engine.finished.clear()
        if on:
            engine.pcache.clear()
        engine.reset_stats()
        firsts = first_token_probe(engine)
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        wall = drive(engine, work)
        counts, paths, st = (ops.launch_counts(), ops.dispatch_paths(),
                             engine.stats())
        done = {r.rid: r for r in engine.finished}
        require(len(done) == len(work) and not any(
            r.truncated or len(r.generated) != w["max_new"]
            for r, w in zip((done[w["rid"]] for w in work), work)),
            f"{name} run: not every request finished")
        want_paths = {"paged_packed_attention" + sfx: ops.CUDA,
                      "fused_ln_add": ops.CUDA}
        if on:
            want_paths["copy_pages"] = ops.CUDA
        require(paths == want_paths, f"{name} run took {paths}")
        require(counts["paged_packed_attention" + sfx] == st["ticks"] * L
                and counts["fused_ln_add"] == st["ticks"] * L,
                f"{name} run: packed or LN-add launches {counts} != ticks x "
                f"layers")
        out[name] = dict(done=done, firsts=firsts, counts=counts, st=st,
                         wall=wall, leaves=sum(len(engine.cache[p])
                                               for p in ("block0",
                                                         "blocks")))
        del engine
        torch.cuda.empty_cache()
    hot, cold = out["hot"], out["cold"]
    pst = hot["st"]["prefix"]
    hits = [rid for rid, r in hot["done"].items() if r.prefix_hit_tokens]
    diff = max((hot["firsts"][rid][0] - cold["firsts"][rid][0]).abs().max()
               .item() for rid in hits)
    same = sum(hot["done"][rid].generated == cold["done"][rid].generated
               for rid in hot["done"])
    common = [common_prefix(hot["done"][rid].generated,
                            cold["done"][rid].generated)
              / len(cold["done"][rid].generated) for rid in cold["done"]]
    ttft = {k: statistics.median(out[k]["firsts"][rid][1] for rid in hits)
            for k in ("hot", "cold")}
    copies = hot["counts"]["page_copy"]
    print(f"  hit rate {pst['hit_rate']:.4f} ({pst['hits']} hits, "
          f"{pst['misses']} misses); prefill tokens hot "
          f"{hot['st']['prefill_tokens']} vs cold "
          f"{cold['st']['prefill_tokens']}; COW copies {pst['cow_copies']}, "
          f"page_copy launches {copies} ({out['hot']['leaves']} pool "
          f"leaves); a1_sig seeded {pst['a1_sig_seeded']}")
    print(f"  hit requests' TTFT p50 hot {ttft['hot']:.2f} ms vs cold "
          f"{ttft['cold']:.2f} ms; ticks hot {hot['st']['ticks']} vs cold "
          f"{cold['st']['ticks']}; wall hot {hot['wall']:.2f} s vs cold "
          f"{cold['wall']:.2f} s")
    print(f"  hot run's stats()['prefix'] TTFT p50: hits "
          f"{pst['ttft_hit_ticks']['p50']} ticks / "
          f"{pst['ttft_hit_ms']['p50']:.2f} ms, misses "
          f"{pst['ttft_cold_ticks']['p50']} ticks / "
          f"{pst['ttft_cold_ms']['p50']:.2f} ms")
    print(f"  first-token logits of the {len(hits)} hits, max |hot - cold| "
          f"{diff:.4f} (bound {DUAL_LOGIT_BOUND}); streams equal hot vs "
          f"cold {same}/{len(work)}; mean common-prefix fraction "
          f"{statistics.mean(common):.3f}; launches {hot['counts']}",
          flush=True)
    require(pst["hit_rate"] > 0.9, f"hit rate {pst['hit_rate']} <= 0.9")
    require(copies == pst["cow_copies"] and copies > 0,
            f"page_copy launches {copies} != COW copies "
            f"{pst['cow_copies']} (one launch a COW for all "
            f"{out['hot']['leaves']} pool leaves)")
    require(hot["st"]["prefill_tokens"] < cold["st"]["prefill_tokens"],
            "the hot run prefilled no fewer tokens than the cold run")
    require(diff <= DUAL_LOGIT_BOUND, f"hit logits differ from cold by "
            f"{diff} > {DUAL_LOGIT_BOUND}")
    return {"page_copy": copies,
            "paged_packed_attention" + sfx:
                hot["counts"]["paged_packed_attention" + sfx]}


#: layers of the quantized engine phases and of the int8 / fp8 padded
#: generations: a seventh of llama3.2-3b's 28, to keep the script inside
#: its time limit beside the MoE, MLA and TP phases (their profiled repeats
#: cost ~60 s each at full depth, most of it the profiler's ~3,500 events
#: a tick; 34.5 s each at 14 layers, ~17 s at 7 until the ssm / hybrid /
#: audio families' TP part joined phase 13a)
QUANT_LAYERS = 4


def quantized_depth(cfg, params, ecfg, prompts):
    """llama3.2-3b cut to its first ``QUANT_LAYERS`` layers (the same
    weights), and the bf16 engine's streams of the profile workload at that
    depth, for the quantized engines to be read against."""
    from repro_torch.serve.scheduler import PagedEngine, ServeRequest
    qcfg = cfg.replace(n_layers=QUANT_LAYERS)
    qparams = dict(params, blocks=params["blocks"][:QUANT_LAYERS - 1])
    engine = PagedEngine(qcfg, qparams, ecfg)
    for i, p in enumerate(prompts):
        engine.submit(ServeRequest(rid=100 + i, prompt=p, max_new=24))
    engine.run()
    streams = {r.rid: list(map(int, r.generated)) for r in engine.finished}
    del engine
    torch.cuda.empty_cache()
    return qcfg, qparams, streams


def quantized_engine_phase(cfg, params, ecfg, prompts, streams, kv):
    """The profile workload (8 requests x 200 prompt tokens, 24 new) on
    ``kv`` pages, twice through one engine (the repeat under
    torch.profiler): the packed kernel's scale variant in every layer of
    every tick, the engine's bytes per page, and the same tokens on the
    repeat.  Reports how far the streams agree with
    the bf16 engine's (not gated: random weights give near-ties).  Returns
    the packed scale variant's launches in the first run."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import PagedEngine, ServeRequest
    L, site = cfg.n_layers, f"paged_packed_attention.{kv}"
    phase(f"quantized engine: the profile workload with EngineConfig("
          f"kv_dtype={kv!r}), {L} layers")
    engine = PagedEngine(cfg, params, dataclasses.replace(ecfg, kv_dtype=kv))
    engine.submit(ServeRequest(rid=-1, prompt=prompts[0][:32], max_new=4))
    engine.run()
    runs = []
    for rep in range(2):
        engine.finished.clear()
        engine.reset_stats()
        for i, p in enumerate(prompts):
            engine.submit(ServeRequest(rid=100 + i, prompt=p, max_new=24))
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t0 = time.perf_counter()
        if rep == 0:
            engine.run()
        else:     # the repeat under torch.profiler: where its time goes
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, paths = ops.launch_counts(), ops.dispatch_paths()
        ticks = engine.stats()["ticks"]
        got = {r.rid: list(map(int, r.generated)) for r in engine.finished}
        require(paths == {site: ops.CUDA, "fused_ln_add": ops.CUDA},
                f"{kv} engine took {paths}")
        require(counts[site] == ticks * L
                and counts["fused_ln_add"] == ticks * L
                and sum(counts.values()) == 2 * ticks * L,
                f"{kv} engine launches {counts} != {ticks} x {L}")
        runs.append((got, counts[site], ticks, wall))
    page_bytes = engine.stats()["pages"]["page_bytes"]
    (got, launches, ticks, wall), (again, _, _, _) = runs
    common = [common_prefix(got[k], v) / len(v) for k, v in streams.items()]
    print(f"  {ticks} ticks in {wall * 1e3:.1f} ms ({wall * 1e3 / ticks:.2f} "
          f"ms/tick); {site} launches {launches} = {ticks} x {L}; "
          f"page_bytes {page_bytes} (bf16 pages: {2 * L * PAGE * HKV * D * 2}"
          f"); repeat gives the same tokens: {got == again}; common-prefix "
          f"fraction with the bf16 engine's streams at {L} layers "
          f"{statistics.mean(common):.3f} (per request "
          f"{[round(c, 3) for c in common]})", flush=True)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(ms for _, ms, _ in rows)
    # bf16 q on one-byte pages runs the tensor-core kernels, never
    # attend_block's paged_packed_kernel
    tc = [r for r in rows if "packed_tc::" in r[0]]
    old = [r for r in rows if "paged_packed_kernel" in r[0]]
    attn_ms = sum(ms for _, ms, _ in tc + old)
    parts = ", ".join(f"{k[:48]}: {ms:.2f} ms in {n}" for k, ms, n in tc + old)
    print(f"  repeat under torch.profiler: device kernel time "
          f"{device_ms:.1f} ms = {device_ms / ticks:.2f} ms/tick (busy share "
          f"of the first run's wall {device_ms / (wall * 1e3):.3f}); "
          f"{sum(n for _, _, n in rows) / ticks:.0f} kernel launches per "
          f"tick; {site} {attn_ms:.2f} ms = "
          f"{attn_ms / max(device_ms, 1e-9):.3f} of device time ({parts}); "
          f"the most device time:")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"    {ms:9.2f} ms {n:6d} calls  {key[:90]}")
    if device_ms > 0.0:
        require(not old and any("attn_kernel" in k for k, _, _ in tc),
                f"the {kv} engine's packed attention did not run the "
                f"tensor-core kernels: {[k[:60] for k, _, _ in tc + old]}")
    else:
        print("  packed attention's kernels: not measured (the profiler saw "
              "no CUDA kernels)")
    want_bytes = L * 2 * (PAGE * HKV * D + PAGE * 4)
    require(page_bytes == want_bytes,
            f"{kv} page_bytes {page_bytes} != {want_bytes}")
    require(got == again, f"a repeated {kv} run gave other tokens")
    del engine
    torch.cuda.empty_cache()
    return launches


#: the padded generation's lanes, chunk and table width
PADDED_B, PADDED_C, PADDED_TB = 8, 128, 128


def padded_lanes(cfg, kv, n_new):
    """The padded generation's prompts (8 lanes, 300 to 512 tokens, seeded)
    and, on the card, their block tables and an empty paged cache (bf16
    pages, or ``kv`` pages with row scales) with room for ``n_new`` more
    tokens a lane: (lens, prompts, block_tables, cache)."""
    import numpy as np
    from repro_torch.models import model as M
    B, C = PADDED_B, PADDED_C
    rng = np.random.default_rng(3)
    lens = rng.integers(300, 513, B)
    require(lens.min() <= 3 * C < lens.max(),
            "the draw should leave some lanes idle in the last prefill tick")
    bt, num_pages = lane_tables(lens + n_new, page=PAGE, tb=PADDED_TB, seed=9)
    prompts = rng.integers(0, cfg.vocab, (B, int(lens.max())))
    cache = M.init_paged_cache(cfg, num_pages, PAGE, B, "bfloat16",
                               kv_dtype=kv)
    return lens, prompts, bt.cuda(), cache


def padded_prefill(params, cfg, lens, prompts, bt, cache):
    """The chunk prefill ticks (C = 128; lanes whose prompt has ended sit
    ticks out with n_valid = 0) into ``cache``, through
    ``paged_decode_step``: returns (each lane's first greedy token, the
    number of ticks)."""
    import numpy as np
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.models import model as M
    from repro_torch.serve.sampling import greedy
    B, C = len(lens), PADDED_C
    seq = ExecutionPlan.single_device("paged")
    dev = lambda a: torch.as_tensor(np.asarray(a, np.int32)).cuda()  # noqa: E731,E501
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


def clone_cache(c):
    return {k: (v.clone() if torch.is_tensor(v) else
                {n: t.clone() for n, t in v.items()})
            for k, v in c.items()}


#: greedy C == 1 ticks of the bf16 padded generation at full depth (32
#: until the ssm / hybrid / audio families' TP part joined phase 13a)
PADDED_NEW = 16


def padded_generation_phase(params, kv="", n_new=32,
                            order=("sequential", "dual", "dual",
                                   "sequential"), cfg=None):
    """Padded (B, C) generation through ``paged_decode_step`` at llama3.2-3b
    full width, at full depth or ``cfg``'s (the engine phase's bf16
    weights, or their first layers; bf16 pages, or int8 / fp8 pages with
    row scales for ``kv``): chunk prefill ticks
    (``padded_prefill``), then ``n_new`` greedy C == 1 ticks sequentially,
    and the same from the same prefilled cache under the dual-branch plan
    (on quantized pages its blocks take the two-op route: the decode
    kernel's scale variant and ``mlp_apply``, nothing fused).  The counters
    are zeroed just before and read just after each run.  The decode runs
    go in turns as ``order`` says, each from its own copy of the prefilled
    cache.  Then the prefill again under torch.profiler from a copy of the
    empty cache (its device time a tick; the tensor-core chunk kernel by
    name) and 4 decode ticks of each plan (the key-split decode kernel by
    name, attend_block's never).  Returns {kernel label: launches of the
    first run that drives it}."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import ops
    B, C, tb = PADDED_B, PADDED_C, PADDED_TB
    cfg = cfg or get_config("llama3.2-3b")
    L = cfg.n_layers
    sfx = f".{kv}" if kv else ""
    phase(f"padded generation: llama3.2-3b, {L} layers, bf16, "
          f"{kv + ' pages' if kv else 'bf16 pages'}, {B} lanes, C={C} "
          f"prefill, {n_new} greedy decode ticks, Tb={tb}")
    lens, prompts, bt, cache = padded_lanes(cfg, kv, n_new)
    empty = clone_cache(cache)
    seq = ExecutionPlan.single_device("paged")
    dual = seq.with_dual_branch()

    def run_counted(fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, ops.launch_counts(), \
            ops.dispatch_paths()

    def decode(c, first, plan, n=n_new):
        return padded_decode(params, cfg, lens, bt, c, first, plan, n)

    with torch.no_grad():
        (first, n_pre), pre_s, pre_counts, pre_paths = run_counted(
            lambda: padded_prefill(params, cfg, lens, prompts, bt, cache))
        require(set(pre_paths.values()) == {ops.CUDA},
                f"prefill took a non-kernel path: {pre_paths}")
        require(pre_counts == {**{k: 0 for k in pre_counts},
                               "paged_chunk_attention" + sfx: n_pre * L,
                               "fused_ln_add": n_pre * L},
                f"prefill launches {pre_counts} != {n_pre} x {L} chunk")
        print(f"  prompts {lens.tolist()}; prefill {n_pre} chunk ticks in "
              f"{pre_s:.2f} s; launches {pre_counts}")
        # fal: one fused_ln_add per layer per tick, sequential or dual
        want = {"sequential": {"paged_decode_attention" + sfx: n_new * L,
                               "fused_ln_add": n_new * L},
                "dual": {"paged_decode_attention": n_new,
                         "fused_dual_branch_decode": n_new * (L - 1),
                         "fused_ln_add": n_new * L}}
        if kv:
            want["dual"] = want["sequential"]
        copies = [clone_cache(cache) for _ in order[1:]] + [cache]
        prof_cache = clone_cache(cache)
        # one tick of each plan first (allocations, GEMM heuristics): it
        # writes the K/V that the timed run's first tick writes again
        decode(copies[0], first, seq, n=1)
        decode(copies[1], first, dual, n=1)
        runs = {"sequential": [], "dual": []}
        for name, c in zip(order, copies):
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
            runs[name].append((toks, lg, counts, secs / n_new * 1e3))
        # the prefill's device time a tick, from the empty cache again
        tick_device_time(
            "prefill", lambda: padded_prefill(params, cfg, lens, prompts, bt,
                                              empty),
            pre_s / n_pre * 1e3, n_pre, want=PREFILL_KERNELS,
            avoid=("paged_chunk_kernel",))
        for name in ("sequential", "dual"):
            tick_device_time(name, lambda: decode(
                prof_cache, first, seq if name == "sequential" else dual,
                n=PROFILED_TICKS), runs[name][0][3], PROFILED_TICKS,
                want=DECODE_KERNELS[kv or "bf16"][name],
                avoid=("paged_decode_kernel", "dual_branch_kernel"))
    (toks_s, lg_s, seq_counts, _) = runs["sequential"][0]
    (toks_d, lg_d, dual_counts, _) = runs["dual"][0]
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
    require(all(torch.equal(r[0], rs[0][0]) for rs in runs.values()
                for r in rs), "a repeated decode run gave other tokens")
    return {"paged_chunk_attention" + sfx:
                pre_counts["paged_chunk_attention" + sfx],
            "paged_decode_attention" + sfx:
                seq_counts["paged_decode_attention" + sfx],
            **({} if kv else {"fused_dual_branch_decode":
                              dual_counts["fused_dual_branch_decode"]})}


#: padded decode ticks under the profiler, a plan each
PROFILED_TICKS = 4

# --------------------------------------------------------------------------- #
# contiguous-cache decode: decode_step, serve.decode.ContinuousBatcher
# --------------------------------------------------------------------------- #
#: card vs CPU on the contiguous cache: S keys a lane, the ticks, and each
#: lane's (first position, advances every tick): lane 0 starts at 0, lane 1
#: reaches S - 1 on the last tick, and the lanes that advance only after odd
#: ticks re-decode their (token, position) in between (the cache write is
#: idempotent, so an idle lane needs no mask)
CONTIG_S, CONTIG_TICKS = 256, 12
CONTIG_LANES = ((0, True), (CONTIG_S - CONTIG_TICKS, True), (17, True),
                (100, False), (128, True), (200, False), (63, True),
                (31, False))
#: gemma2's one contiguous tick (window 128 binds on the local layer)
G2_CONTIG_S = 512
G2_CONTIG_LANES = tuple((p, True) for p in (0, 127, 128, 300, 511, 100, 200,
                                            129))
#: decode == forward at llama3.2-3b full depth in bf16: B lanes of S tokens
CONTIG_FWD_B, CONTIG_FWD_S = 4, 128
#: bound on |logit| differences between decode_step and forward at
#: llama3.2-3b in bf16, over all B x S x 128256 logits.  The two attend in
#: other orders with other bf16 rounding points (forward: the flash kernel,
#: P rounded to bf16 before its division by the row sum; decode: fp32 scores
#: over the whole cache, P normalised, then rounded), and the residual
#: stream rounds each block's output to bf16 (relative 2^-9): as
#: DUAL_LOGIT_BOUND, differences enter in each of 28 blocks and reach logits
#: of order 1 through the final norm; the logits themselves are bf16 (one
#: ulp is 2^-5 at |logit| >= 4)
CONTIG_FWD_BOUND = 0.25
#: the batcher's workload: slots, max_seq, requests, prompt tokens, new
BATCHER_SLOTS, BATCHER_MAX_SEQ, BATCHER_REQS = 8, 512, 16
#: (16 new tokens since the ssm / hybrid / audio families' TP part joined
#: phase 13a; 32 before)
BATCHER_PROMPT, BATCHER_NEW = (32, 128), 16
BATCHER_PROFILED_TICKS = 3


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def contiguous_positions(lanes, n_ticks):
    """(n_ticks, B) int32 positions of the lanes ``(first position,
    advances every tick)``: the others advance only after odd ticks."""
    cur = [p for p, _ in lanes]
    out = []
    for t in range(n_ticks):
        out.append(list(cur))
        cur = [c + 1 if every or t % 2 else c
               for c, (_, every) in zip(cur, lanes)]
    return torch.tensor(out, dtype=torch.int32)


def contiguous_run(cfg, params, cache, toks, positions, plan):
    """``decode_step`` over the ticks: lane b feeds ``toks[b, pos]`` at each
    tick's position -> (n_ticks, B, V) fp32 logits on the host."""
    from repro_torch.models import model as M
    dev = next(iter(cache["block0"].values())).device
    lanes = torch.arange(positions.shape[1])
    out = []
    with torch.no_grad():
        for pos in positions:
            batch = {"tokens": toks[lanes, pos.long()][:, None].to(dev),
                     "pos": pos.to(dev)}
            logits, cache = M.decode_step(params, cfg, batch, cache, plan)
            out.append(logits[:, 0].float().cpu())
    return torch.stack(out)


def contiguous_card_vs_cpu(cfg, params, label, lanes, S, n_ticks,
                           plans=("sequential", "dual"), scaled_tol=False,
                           moe=False):
    """``n_ticks`` contiguous decode ticks at ``lanes`` over a random fp32
    history, on the card (``fused_ln_add``'s kernel) and on the CPU (plain
    versions), from the same CPU ``params`` and cache, for each plan; the
    counters are zeroed before each card run and read after it.  Logits
    within TICK_TOLS' fp32 gate (with ``scaled_tol``: times max(1, the
    largest |logit|), as ``padded_tick``'s); on the card the dual-branch
    logits equal the sequential ones bit for bit (the contiguous route has
    no fused kernel: both plans run the same ops).  ``moe``: as in
    ``padded_tick``, a lane whose routing differs at a near tie in any tick
    is left out of the gate."""
    from repro_torch import interop
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    phase(f"contiguous decode, {label}: {n_ticks} decode_step ticks of "
          f"{len(lanes)} lanes, S={S}, card (kernel) vs CPU (plain), "
          f"{' and '.join(plans)}")
    B, L = len(lanes), cfg.n_layers
    g = torch.Generator().manual_seed(21)
    positions = contiguous_positions(lanes, n_ticks)
    require(int(positions.max()) <= S - 1, "a lane passes the cache")
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32)
    cache = M.init_cache(cfg, B, S, "float32", device="cpu")
    for part in cache.values():
        for name in part:                      # K / V, or MLA's c / kr
            part[name].copy_(torch.randn(part[name].shape, generator=g))
    gparams = interop.tree_to(params, "cuda")
    card = {}
    for name in plans:
        plan = ExecutionPlan.single_device("decode",
                                           dual_branch=name == "dual")
        gcache = interop.tree_to(cache, "cuda")
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t0 = time.perf_counter()
        with routes_if(moe) as routes:
            gpu = contiguous_run(cfg, gparams, gcache, toks, positions, plan)
            secs = time.perf_counter() - t0
            counts, paths = ops.launch_counts(), ops.dispatch_paths()
            cpu = contiguous_run(cfg, params, {k: {n: t.clone() for n, t in
                                                   v.items()}
                                               for k, v in cache.items()},
                                 toks, positions, plan)
        kept = torch.ones(B, dtype=torch.bool)
        if moe:                 # an MoE call's row b is lane b's token
            for lane in {r for _, r, _ in route_flips(routes, label)}:
                kept[lane] = False
        diff = (gpu - cpu)[:, kept].abs().max().item()
        top = cpu.abs().max().item()
        tol = TICK_TOLS[""] * (max(1.0, top) if scaled_tol else 1.0)
        print(f"  {name}: logits max |diff| {diff:.3e} (max |logit| "
              f"{top:.3f}); tol {tol:.3g} (TICK_TOLS"
              f"{' x max |logit|' if scaled_tol else ''}); card "
              f"{secs / n_ticks * 1e3:.2f} ms/tick; paths {paths}; "
              f"launches {nonzero(counts)}", flush=True)
        require(paths == {"fused_ln_add": ops.CUDA},
                f"contiguous {name} ticks ran {paths}")
        require(counts == {**{k: 0 for k in counts},
                           "fused_ln_add": n_ticks * L},
                f"contiguous {name} launches {counts} != {n_ticks} x {L} "
                f"fused_ln_add")
        require(diff <= tol and bool(torch.isfinite(gpu).all()),
                f"contiguous {name} ticks: card disagrees with the CPU")
        card[name] = gpu
    if "dual" in card:
        require(torch.equal(card["sequential"], card["dual"]),
                "contiguous dual-branch logits differ from sequential on "
                "the card")
        print("  dual-branch logits equal the sequential ones bit for bit "
              "on the card", flush=True)


def contiguous_decode_phase(params, smi):
    """Contiguous-cache decode (``models.model.init_cache`` /
    ``decode_step``, ``serve.decode.ContinuousBatcher``): 12 ticks card vs
    CPU at 2 layers fp32, sequential and dual; decode == forward at full
    depth in bf16 (``params``: the engine phase's 28-layer bf16 weights on
    the card); the batcher's workload, timed and 3 ticks profiled; and
    ``obs.run_metadata`` on the card.  Returns {"decode_step": fused_ln_add
    launches of the decode == forward run, "batcher": of the batcher's
    run}."""
    import numpy as np
    from repro_torch import interop
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.obs import run_metadata
    from repro_torch.serve.decode import ContinuousBatcher, Request
    t_phase = time.perf_counter()
    small = get_config("llama3.2-3b").replace(n_layers=2, dtype="float32")
    # drawn on the card, then copied: both sides start from these weights
    cpu_params = interop.tree_to(M.init_params(small, seed=0, device="cuda"),
                                 "cpu")
    torch.cuda.empty_cache()
    contiguous_card_vs_cpu(small, cpu_params,
                           "llama3.2-3b full width, 2 layers, fp32",
                           CONTIG_LANES, CONTIG_S, CONTIG_TICKS)
    del cpu_params

    cfg = get_config("llama3.2-3b")
    L, B, S = cfg.n_layers, CONTIG_FWD_B, CONTIG_FWD_S
    phase(f"contiguous decode == forward: llama3.2-3b, {L} layers, bf16, "
          f"B={B}, S={S}")
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda",
                         dtype=torch.int32)
    with torch.no_grad():
        full = M.forward(params, cfg, {"tokens": toks}, "eval")[0]
        cache = M.init_cache(cfg, B, S, "bfloat16")
        err = torch.zeros((), device="cuda")
        same = torch.zeros((), dtype=torch.long, device="cuda")
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t0 = time.perf_counter()
        for t in range(S):
            logits, cache = M.decode_step(
                params, cfg, {"tokens": toks[:, t:t + 1],
                              "pos": torch.full((B,), t, dtype=torch.int32,
                                                device="cuda")}, cache)
            err = torch.maximum(err, (logits[:, 0].float()
                                      - full[:, t].float()).abs().max())
            same += (logits[:, 0].argmax(-1) == full[:, t].argmax(-1)).sum()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    err, top = err.item(), full.float().abs().max().item()
    print(f"  {S} ticks in {secs:.2f} s = {secs / S * 1e3:.2f} ms/tick; "
          f"logits max |decode - forward| {err:.4f} (bound "
          f"{CONTIG_FWD_BOUND}; max |logit| {top:.3f}); greedy tokens equal "
          f"at {same.item()} of {B * S} positions; paths {paths}; launches "
          f"{nonzero(counts)}", flush=True)
    require(paths == {"fused_ln_add": ops.CUDA},
            f"contiguous decode ran {paths}")
    require(counts == {**{k: 0 for k in counts}, "fused_ln_add": S * L},
            f"contiguous decode launches {counts} != {S} ticks x {L} "
            f"fused_ln_add")
    require(err <= CONTIG_FWD_BOUND, f"decode differs from forward by {err}")
    del full, cache
    launches = {"decode_step": counts["fused_ln_add"]}

    phase(f"ContinuousBatcher: llama3.2-3b, {L} layers, bf16, "
          f"{BATCHER_SLOTS} slots, max_seq {BATCHER_MAX_SEQ}, "
          f"{BATCHER_REQS} greedy requests of {BATCHER_PROMPT[0]}.."
          f"{BATCHER_PROMPT[1]} prompt tokens + {BATCHER_NEW}")
    rng = np.random.default_rng(11)
    warm = ContinuousBatcher(cfg, params, 2, 64, cache_dtype="bfloat16")
    warm.submit(Request(rid=-1, prompt=rng.integers(0, cfg.vocab, 4),
                        max_new=2))
    warm.run()
    del warm
    eng = ContinuousBatcher(cfg, params, BATCHER_SLOTS, BATCHER_MAX_SEQ,
                            cache_dtype="bfloat16")
    lens = rng.integers(BATCHER_PROMPT[0], BATCHER_PROMPT[1] + 1,
                        BATCHER_REQS)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)),
                    max_new=BATCHER_NEW) for i, n in enumerate(lens)]
    for r in reqs:
        eng.submit(r)
    tick_ms, done = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    ops.reset_dispatch_paths()
    t0 = time.perf_counter()
    while any(s is not None for s in eng.slots) or eng.queue:
        t1 = time.perf_counter()
        done += eng.step()        # ends in the next tokens' copy to the host
        tick_ms.append((time.perf_counter() - t1) * 1e3)
    secs = time.perf_counter() - t0
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    st = eng.stats()
    n_tok = sum(len(r.generated) for r in done)
    p50, p99 = np.percentile(tick_ms, [50, 99])
    print(f"  {len(done)} requests (prompts {lens.tolist()}), {st['ticks']} "
          f"ticks in {secs:.2f} s: {n_tok / secs:.1f} generated tok/s; ms a "
          f"tick p50 {p50:.2f} p99 {p99:.2f}; dispatches_per_tick "
          f"{st['dispatches_per_tick']}; mean occupancy "
          f"{st['mean_occupancy']:.3f}; launches {nonzero(counts)}; card "
          f"{smi}",
          flush=True)
    require(len(done) == BATCHER_REQS
            and all(len(r.generated) == BATCHER_NEW for r in done),
            "the batcher left a request unfinished")
    require(st["dispatches_per_tick"] == 1.0, "more than one dispatch a tick")
    require(paths == {"fused_ln_add": ops.CUDA}, f"the batcher ran {paths}")
    require(counts == {**{k: 0 for k in counts},
                       "fused_ln_add": st["ticks"] * L},
            f"batcher launches {counts} != {st['ticks']} ticks x {L}")
    launches["batcher"] = counts["fused_ln_add"]
    for r in reqs[:BATCHER_SLOTS]:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new=BATCHER_NEW))
    eng.step()
    busy = tick_device_time(
        "batcher tick (8 lanes)",
        lambda: [eng.step() for _ in range(BATCHER_PROFILED_TICKS)],
        float(p50), BATCHER_PROFILED_TICKS, want=("ln_add_fwd_kernel",))
    print(f"  batcher tick_device_time: "
          f"{'not measured' if busy is None else f'{busy:.3f} ms'} a tick; "
          f"card {smi}", flush=True)

    meta = run_metadata(timestamp=time.time(), repo_dir=str(ROOT),
                        dispatch_paths=ops.dispatch_paths())
    print(f"  run_metadata: {json.dumps(meta)}", flush=True)
    require(meta["device_kind"] == torch.cuda.get_device_name(0)
            and meta["power_limit"].splitlines()[0] == smi
            and "jax_version" not in meta,
            "run_metadata does not name the card and its power limit")
    print(f"  contiguous decode phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, {"tok_s": n_tok / secs, "tick_ms_p50": float(p50),
                      "tick_ms_p99": float(p99), "tick_device_ms": busy}


def padded_decode(params, cfg, lens, bt, cache, first, plan, n):
    """``n`` greedy C == 1 ticks of ``paged_decode_step`` from the tokens
    ``first`` at positions ``lens``: (tokens (B, n) on the host, the first
    tick's fp32 logits)."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.serve.sampling import greedy
    B = len(lens)
    dev = lambda a: torch.as_tensor(np.asarray(a, np.int32)).cuda()  # noqa: E731,E501
    tok, out, first_logits = first.clone(), [], None
    for i in range(n):
        batch = dict(tokens=tok[:, None].int(), pos=dev(lens + i),
                     n_valid=dev(np.ones(B)), block_tables=bt)
        logits, _ = M.paged_decode_step(params, cfg, batch, cache, plan)
        if i == 0:
            first_logits = logits[:, 0].float()
        tok = greedy(logits[:, 0]).long()
        out.append(tok)
    return torch.stack(out, 1).cpu(), first_logits


def busy_ms(prof):
    """The time at least one CUDA kernel ran, in ms: the union of the
    kernels' intervals in a profile.  Kernels launched as programmatic
    dependents (a combine or finishing grid) start while the kernel before
    them runs and wait for it, so summing kernel times counts that overlap
    twice."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


#: kernels a profiled padded tick must run, by page type and tick: the
#: decode's key-split kernel; on bf16 pages the dual tick's blocks also the
#: tensor-core fused grid (on one-byte pages the dual route is the decode
#: kernel and mlp_apply); a prefill tick the tensor-core attention kernel
#: over chunk items
SPLIT = "decode_splits::split_kernel"
DECODE_KERNELS = {
    "bf16": {"sequential": (SPLIT,), "dual": (SPLIT, "dual_tc_kernel")},
    "int8": {"sequential": (SPLIT + "<signed char",),
             "dual": (SPLIT + "<signed char",)},
    "fp8": {"sequential": (SPLIT + "<__nv_fp8_e4m3",),
            "dual": (SPLIT + "<__nv_fp8_e4m3",)}}
PREFILL_KERNELS = ("packed_tc::ChunkItems",)


def tick_device_time(name, run, wall_ms, n_ticks, want=(), avoid=()):
    """Device time of a padded tick (the time any CUDA kernel ran over the
    ``n_ticks`` ticks that ``run`` drives under torch.profiler; also the sum
    of the kernels' own times) beside the counted run's wall ms/tick, and
    the kernels that ran: every name in ``want`` among them, none in
    ``avoid`` (attend_block's paged_decode_kernel, dual_branch_kernel,
    paged_chunk_kernel).  Returns the busy ms a tick (None when the
    profiler saw no CUDA kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(ms for _, ms, _ in rows)
    if device_ms == 0.0:
        print(f"  {name}: device time not measured (the profiler saw no "
              f"CUDA kernels); wall {wall_ms:.2f} ms/tick")
        return None
    busy = busy_ms(prof) / n_ticks
    print(f"  {name}: device time {busy:.3f} ms/tick busy (kernel times "
          f"summed: {device_ms / n_ticks:.3f}; torch.profiler, {n_ticks} "
          f"ticks) beside the counted run's wall {wall_ms:.2f} ms/tick; the "
          f"most device time (a dependent grid's time includes its wait):")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"    {ms:9.3f} ms {n:6d} calls  {key[:90]}")
    names = " ".join(k for k, _, _ in rows)
    for w in want:
        require(w in names, f"the {name} tick ran no {w}")
    for a in avoid:
        require(a not in names, f"the {name} tick ran attend_block's {a}")
    sys.stdout.flush()
    return busy


# --------------------------------------------------------------------------- #
# training: flash_attention and fused_ln_add, forward and backward
# --------------------------------------------------------------------------- #
#: (label, B, S, H, Hkv, D, causal): the training shape of llama3.2-3b and
#: small odd shapes (S not a multiple of the 64- or 128-row tiles, G = 1 to
#: 4, D = 32 also non-causal with G = 3)
FLASH_SHAPES = (("train", 1, 2048, H, HKV, D, True),
                ("qwen3-moe train", 1, 2048, MOE_H, MOE_HKV, D, True),
                ("odd", 2, 77, 4, 2, 32, True),
                ("odd", 3, 130, 4, 1, 64, True),
                ("odd", 1, 200, 8, 8, 128, True),
                ("odd", 2, 91, 4, 2, 64, False),
                ("odd", 1, 150, 6, 2, 32, False))
#: (B, Sq, Sk, H, Hkv, D, q_offset): queries at the end of a longer key
#: sequence, causal from q_offset (Sq != Sk), as a chunked prefill calls it
FLASH_OFFSET_SHAPES = ((1, 100, 260, 6, 2, 128, 160), (2, 70, 200, 4, 4, 64, 5),
                       (1, 33, 300, 3, 1, 32, 267))
#: gemma2-27b's attention heads (32 query, 16 KV, head dim 128), its local
#: layers' window and its attention softcap
G2_H, G2_HKV, G2_D, G2_WINDOW, G2_CAP = 32, 16, 128, 4096, 50.0
#: (label, B, Sq, Sk, H, Hkv, D, causal, q_offset, window, cap): the sliding
#: window and the logit softcap: gemma2's training shape (the window binds
#: from row 4096 on); at gemma2's heads a window of one key (the diagonal
#: alone), one of 100 keys (not a multiple of the 64-key tiles), one of 64,
#: the cap alone, the window alone, a window past the end (Sk + 5: the same
#: as none), and queries at a q_offset into a longer key sequence; at small
#: heads D = 32 and 64, a non-causal window, G = 1 and 2
FLASH_WINDOW_SHAPES = (
    ("gemma2 train", 1, 6144, 6144, G2_H, G2_HKV, G2_D, True, 0, G2_WINDOW,
     G2_CAP),
    ("edge", 1, 300, 300, G2_H, G2_HKV, G2_D, True, 0, 1, G2_CAP),
    ("edge", 1, 300, 300, G2_H, G2_HKV, G2_D, True, 0, 1, 0.0),
    ("edge", 1, 300, 300, G2_H, G2_HKV, G2_D, True, 0, 100, G2_CAP),
    ("edge", 1, 300, 300, G2_H, G2_HKV, G2_D, True, 0, 100, 0.0),
    ("edge", 1, 300, 300, G2_H, G2_HKV, G2_D, True, 0, 64, G2_CAP),
    ("edge", 1, 300, 300, G2_H, G2_HKV, G2_D, True, 0, 0, G2_CAP),
    ("edge", 1, 300, 300, G2_H, G2_HKV, G2_D, True, 0, 305, G2_CAP),
    ("q_offset", 1, 100, 260, G2_H, G2_HKV, G2_D, True, 160, 100, G2_CAP),
    ("q_offset", 2, 70, 200, 4, 2, 64, True, 5, 30, 0.0),
    ("small", 2, 77, 77, 4, 2, 32, True, 0, 5, 30.0),
    ("small", 3, 130, 130, 4, 1, 64, True, 0, 70, 30.0),
    ("small", 1, 91, 91, 4, 2, 64, False, 0, 20, 30.0))
#: (label, B, S, H, Hkv, D, Dv, causal): MLA's heads at D = 192 (qk 128 +
#: 64, v 128 padded by the wrapper to 192): deepseek-v3's training shape
#: (128 heads, each its own expanded K / V head), then small odd shapes (S
#: not a multiple of the 32-row tiles, G = 2, a full-width v, non-causal)
FLASH_MLA_SHAPES = (("deepseek-v3 train", 1, 2048, 128, 128, 192, 128, True),
                    ("odd", 2, 77, 6, 3, 192, 128, True),
                    ("odd", 1, 300, 4, 4, 192, 192, True),
                    ("odd", 1, 200, 4, 2, 192, 128, False))
#: (label, B, Sq, Sk, H, Hkv, D): whisper-small's attention, 12 heads of
#: 64 and no mask: the encoder over its 1,500 frames (not a multiple of the
#: 64-key tiles), the decoder's cross-attention at the training length 448
#: and at one decode step; WHISPER_TIMED_B is the batch phase 4 times them
#: at (phase 17's training and serving batch)
FLASH_WHISPER_SHAPES = (("whisper encoder", 2, 1500, 1500, 12, 12, 64),
                        ("whisper cross", 2, 448, 1500, 12, 12, 64),
                        ("whisper decode cross", 8, 1, 1500, 12, 12, 64))
WHISPER_TIMED_B = 8
#: kernel vs plain: fp32 sums in another order; bf16: one rounding of the
#: output (|o| < 4: 2^-7 x 4 = 0.03) and of each gradient
FLASH_TOLS = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: kernel vs autograd through the plain forward, relative to the largest
#: gradient: fp32 sums in another order; in bf16 the plain forward rounds
#: p to bf16 before P.V and its autograd rounds each product, the kernel
#: keeps fp32 to the end
GRAD_TOLS = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
#: (kind, rows, d): the training shapes (llama3.2-3b rmsnorm, gpt2
#: layernorm), the engine's token budget (263 rows of llama3.2-3b), fewer
#: rows than the backward's grid of two blocks an SM, the padded decode
#: tick's 8 lanes, odd row widths (scalar loads), and qwen3-moe-30b-a3b's
#: training and engine rows (phase 15); the first LN_TIMED are also timed
LN_SHAPES = (("rmsnorm", 2048, 3072), ("layernorm", 2048, 768),
             ("rmsnorm", 263, 3072), ("layernorm", 100, 768),
             ("rmsnorm", 8, 3072), ("rmsnorm", 37, 200),
             ("layernorm", 5, 1001), ("rmsnorm", 2048, 2048),
             ("rmsnorm", 263, 2048))
LN_TIMED = 5


def flash_inputs(dtype, B, S, h, hkv, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (randn(g, dtype, B, S, h, d), randn(g, dtype, B, S, hkv, d),
            randn(g, dtype, B, S, hkv, d), randn(g, dtype, B, S, h, d))


def rel_err(out, ref):
    return max_err(out, ref) / max(ref.float().abs().max().item(), 1e-30)


def flash_kernel_phase():
    """flash_attention forward (O and lse) and backward against the plain
    versions on the same inputs; the backward also against autograd
    through the plain forward, and twice for bit-identical results; then
    queries at a q_offset into a longer key sequence."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.attention import blockwise_attention
    phase("kernel: flash_attention forward and backward vs plain")
    errs = {"flash_attention": 0.0, "flash_attention.bwd": 0.0}
    for (label, B, S, h, hkv, d, causal), dtype in itertools.product(
            FLASH_SHAPES, (torch.float32, torch.bfloat16)):
        q, k, v, do = flash_inputs(dtype, B, S, h, hkv, d, seed=S + d)
        tol = FLASH_TOLS[dtype]
        o, lse = FA.flash_attention_fwd_cuda(q, k, v, causal=causal)
        r_o, r_lse = FA.flash_attention_plain(q, k, v, causal=causal)
        e_o, e_l = max_err(o, r_o), max_err(lse, r_lse)
        grads = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            causal=causal)
        again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            causal=causal)
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal)
        e_g = max(rel_err(a, b) for a, b in zip(grads, plain))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        blockwise_attention(*leaves, causal=causal).backward(do)
        e_a = max(rel_err(a, b.grad) for a, b in zip(grads, leaves))
        torch.cuda.synchronize()
        name = f"{label} B={B} S={S} H={h} Hkv={hkv} D={d} " \
               f"{'causal' if causal else 'full'} {str(dtype)[6:]}"
        print(f"  {name}: o {e_o:.3e}, lse {e_l:.3e} (tol {tol:g}); grads "
              f"vs plain {e_g:.3e} (relative, tol {tol:g}), vs autograd "
              f"{e_a:.3e} (relative, tol {GRAD_TOLS[dtype]:g}); two "
              f"backward runs bit-identical {same}", flush=True)
        require(e_o <= tol and e_l <= tol, f"{name}: forward disagrees")
        require(e_g <= tol, f"{name}: backward disagrees with its plain "
                f"version")
        require(e_a <= GRAD_TOLS[dtype], f"{name}: backward disagrees with "
                f"autograd through the plain forward")
        require(same, f"{name}: backward is not deterministic")
        if label == "train" and dtype == torch.bfloat16:
            errs = {"flash_attention": e_o, "flash_attention.bwd": e_g}
    for (B, Sq, Sk, h, hkv, d, qo), dtype in itertools.product(
            FLASH_OFFSET_SHAPES, (torch.float32, torch.bfloat16)):
        g = torch.Generator(device="cuda").manual_seed(Sq + Sk)
        q, do = (randn(g, dtype, B, Sq, h, d) for _ in range(2))
        k, v = (randn(g, dtype, B, Sk, hkv, d) for _ in range(2))
        tol = FLASH_TOLS[dtype]
        o, lse = FA.flash_attention_fwd_cuda(q, k, v, q_offset=qo)
        r_o, r_lse = FA.flash_attention_plain(q, k, v, q_offset=qo)
        grads = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, q_offset=qo)
        plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             q_offset=qo)
        torch.cuda.synchronize()
        e_o, e_l = max_err(o, r_o), max_err(lse, r_lse)
        e_g = max(rel_err(a, b) for a, b in zip(grads, plain))
        name = f"q_offset {qo}: B={B} Sq={Sq} Sk={Sk} H={h} Hkv={hkv} " \
               f"D={d} causal {str(dtype)[6:]}"
        print(f"  {name}: o {e_o:.3e}, lse {e_l:.3e}; grads vs plain "
              f"{e_g:.3e} (relative; tol {tol:g})", flush=True)
        require(e_o <= tol and e_l <= tol and e_g <= tol,
                f"{name}: kernels disagree with the plain versions")
    t0 = time.perf_counter()
    for case, dtype in itertools.product(FLASH_WINDOW_SHAPES,
                                         (torch.float32, torch.bfloat16)):
        e_o, e_g = flash_window_case(FA, blockwise_attention, case, dtype)
        if case[0] == "gemma2 train" and dtype == torch.bfloat16:
            errs.update({"flash_attention.gemma2": e_o,
                         "flash_attention.bwd.gemma2": e_g})
    check_window_past_end(FA)
    print(f"  window and softcap cases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    for case, dtype in itertools.product(FLASH_MLA_SHAPES,
                                         (torch.float32, torch.bfloat16)):
        e_o, e_g = flash_mla_case(FA, case, dtype)
        if case[0] == "deepseek-v3 train" and dtype == torch.bfloat16:
            errs.update({"flash_attention.mla": e_o,
                         "flash_attention.bwd.mla": e_g})
    print(f"  D = 192 (MLA) cases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    for case, dtype in itertools.product(FLASH_WHISPER_SHAPES,
                                         (torch.float32, torch.bfloat16)):
        e_o, e_g = flash_whisper_case(FA, case, dtype)
        if case[0] == "whisper encoder" and dtype == torch.bfloat16:
            errs.update({"flash_attention.whisper": e_o,
                         "flash_attention.bwd.whisper": e_g})
    print(f"  whisper cases: {time.perf_counter() - t0:.1f} s", flush=True)
    return errs


def flash_whisper_case(FA, case, dtype):
    """One FLASH_WHISPER_SHAPES case, no mask (``causal=False``), Sq and Sk
    as given: o, lse and the gradients against the plain versions, the
    backward twice for bit-identical results.  -> (o error, relative
    gradient error)."""
    label, B, Sq, Sk, h, hkv, d = case
    g = torch.Generator(device="cuda").manual_seed(Sq + Sk)
    q, do = (randn(g, dtype, B, Sq, h, d) for _ in range(2))
    k, v = (randn(g, dtype, B, Sk, hkv, d) for _ in range(2))
    tol = FLASH_TOLS[dtype]
    o, lse = FA.flash_attention_fwd_cuda(q, k, v, causal=False)
    r_o, r_lse = FA.flash_attention_plain(q, k, v, causal=False)
    grads = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=False)
    again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=False)
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    e_o, e_l = max_err(o, r_o), max_err(lse, r_lse)
    e_g = max(rel_err(a, b) for a, b in zip(grads, plain))
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    name = f"{label}: B={B} Sq={Sq} Sk={Sk} H={h} Hkv={hkv} D={d} full " \
           f"{str(dtype)[6:]}"
    print(f"  {name}: o {e_o:.3e}, lse {e_l:.3e}; grads vs plain {e_g:.3e} "
          f"(relative; tol {tol:g}); two backward runs bit-identical "
          f"{same}", flush=True)
    require(e_o <= tol and e_l <= tol and e_g <= tol,
            f"{name}: kernels disagree with the plain versions")
    require(same, f"{name}: backward is not deterministic")
    return e_o, e_g


def flash_mla_case(FA, case, dtype):
    """One FLASH_MLA_SHAPES case through the wrapper MLA calls
    (``flash_attention``: v padded to D = 192 on the card, the first Dv
    columns of o kept, autograd through the pad): o and the gradients
    against the plain versions at the unpadded width, the backward twice
    for the same bits.  Returns (o error, largest relative gradient
    error)."""
    label, B, S, h, hkv, d, dv, causal = case
    g = torch.Generator(device="cuda").manual_seed(S + dv)
    q, k = randn(g, dtype, B, S, h, d), randn(g, dtype, B, S, hkv, d)
    v, do = randn(g, dtype, B, S, hkv, dv), randn(g, dtype, B, S, h, dv)
    tol = FLASH_TOLS[dtype]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = FA.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(o, leaves, do)
    again = torch.autograd.grad(FA.flash_attention(*leaves, causal=causal),
                                leaves, do)
    r_o, r_lse = FA.flash_attention_plain(q, k, v, causal=causal)
    plain = FA.flash_attention_bwd_plain(q, k, v, r_o, r_lse, do,
                                         causal=causal)
    torch.cuda.synchronize()
    e_o = max_err(o, r_o)
    e_g = max(rel_err(a, b) for a, b in zip(grads, plain))
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    name = f"{label} B={B} S={S} H={h} Hkv={hkv} D={d} Dv={dv} " \
           f"{'causal' if causal else 'full'} {str(dtype)[6:]}"
    print(f"  {name}: o {e_o:.3e} (tol {tol:g}); grads vs plain {e_g:.3e} "
          f"(relative, tol {tol:g}); two backward runs bit-identical "
          f"{same}", flush=True)
    require(o.shape == (B, S, h, dv), f"{name}: o is {tuple(o.shape)}")
    require(e_o <= tol and e_g <= tol,
            f"{name}: the D = 192 kernels disagree with the plain versions")
    require(same, f"{name}: backward is not deterministic")
    return e_o, e_g


def _flash_visible_pairs(Sq, Sk, causal, q_offset, window):
    """(query, key) pairs one head sees: row i sees keys j < Sk with
    j <= q_offset + i (causal) and j > q_offset + i - window (window > 0)."""
    n = 0
    for i in range(Sq):
        hi = min(Sk, q_offset + i + 1) if causal else Sk
        lo = max(0, q_offset + i - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def flash_window_case(FA, blockwise_attention, case, dtype):
    """One FLASH_WINDOW_SHAPES case: the forward (o, lse) and backward
    kernels against the plain versions with the same window and cap, the
    backward twice for the same bits, and (below 1000 rows) against
    autograd through the plain forward.  Returns (o error, gradient
    error)."""
    label, B, Sq, Sk, h, hkv, d, causal, qo, window, cap = case
    g = torch.Generator(device="cuda").manual_seed(Sq + Sk + window)
    q, do = (randn(g, dtype, B, Sq, h, d) for _ in range(2))
    k, v = (randn(g, dtype, B, Sk, hkv, d) for _ in range(2))
    kw = dict(causal=causal, q_offset=qo, window=window, cap=cap)
    tol = FLASH_TOLS[dtype]
    o, lse = FA.flash_attention_fwd_cuda(q, k, v, **kw)
    r_o, r_lse = FA.flash_attention_plain(q, k, v, **kw)
    grads = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    e_o, e_l = max_err(o, r_o), max_err(lse, r_lse)

    def grad_err(got, want):
        # each gradient relative to its largest value, floored at 10% of
        # the largest of the three: under a window of one key dQ and dK
        # are 0 up to rounding (P = 1 on the diagonal, dP = delta), and
        # their rounding noise has no scale of its own
        top = max(w.float().abs().max().item() for w in want)
        return max(max_err(a, b) / max(b.float().abs().max().item(),
                                       0.1 * top, 1e-30)
                   for a, b in zip(got, want))
    e_g = grad_err(grads, plain)
    e_a = None
    if Sq < 1000:
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        blockwise_attention(*leaves, **kw).backward(do)
        e_a = grad_err(grads, [t.grad for t in leaves])
    torch.cuda.synchronize()
    name = (f"{label} B={B} Sq={Sq} Sk={Sk} H={h} Hkv={hkv} D={d} "
            f"{'causal' if causal else 'full'} q_offset={qo} window={window} "
            f"cap={cap:g} {str(dtype)[6:]}")
    auto = "" if e_a is None else (
        f", vs autograd {e_a:.3e} (relative, tol {GRAD_TOLS[dtype]:g})")
    print(f"  {name}: o {e_o:.3e}, lse {e_l:.3e} (tol {tol:g}); grads vs "
          f"plain {e_g:.3e} (relative, tol {tol:g}){auto}; two backward "
          f"runs bit-identical {same}", flush=True)
    require(e_o <= tol and e_l <= tol, f"{name}: forward disagrees")
    require(e_g <= tol, f"{name}: backward disagrees with its plain version")
    require(e_a is None or e_a <= GRAD_TOLS[dtype],
            f"{name}: backward disagrees with autograd through the plain "
            f"forward")
    require(same, f"{name}: backward is not deterministic")
    return e_o, e_g


def check_window_past_end(FA):
    """A window of Sk keys or more is no window: o, lse and the gradients
    equal the window = 0 results bit for bit (fp32 and bf16, with and
    without the cap, a causal and a q_offset call)."""
    for (B, Sq, Sk, qo), dtype, cap in itertools.product(
            ((1, 300, 300, 0), (1, 100, 260, 160)),
            (torch.float32, torch.bfloat16), (0.0, G2_CAP)):
        g = torch.Generator(device="cuda").manual_seed(Sq + qo)
        q, do = (randn(g, dtype, B, Sq, G2_H, G2_D) for _ in range(2))
        k, v = (randn(g, dtype, B, Sk, G2_HKV, G2_D) for _ in range(2))
        outs = []
        for window in (0, Sk, Sk + 37):
            kw = dict(q_offset=qo, window=window, cap=cap)
            o, lse = FA.flash_attention_fwd_cuda(q, k, v, **kw)
            outs.append((o, lse) + FA.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, **kw))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for other in outs[1:]
                   for a, b in zip(outs[0], other))
        name = (f"Sq={Sq} Sk={Sk} q_offset={qo} cap={cap:g} "
                f"{str(dtype)[6:]}")
        print(f"  window Sk and Sk + 37 vs none, {name}: o, lse, dq, dk, dv "
              f"bit-identical {same}", flush=True)
        require(same, f"{name}: a window past the end changes the result")


def ln_inputs(dtype, kind, rows, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, a1, dy = (randn(g, dtype, rows, d) for _ in range(3))
    scale = 1 + randn(g, torch.float32, d, std=0.1)
    bias = randn(g, torch.float32, d, std=0.1) if kind == "layernorm" \
        else None
    return x, a1, scale, bias, dy


def ln_kernel_phase():
    """fused_ln_add forward and backward against the plain version (and
    autograd through it) on the same inputs; the backward twice; the
    forward's y the same bits without the statistics, and its first rows
    the same bits in calls of 8 rows and of 1 row."""
    from repro_torch.kernels import fused_ln_add as LN
    phase("kernel: fused_ln_add forward and backward vs plain")
    errs = {}
    for (kind, rows, d), dtype in itertools.product(
            LN_SHAPES, (torch.float32, torch.bfloat16)):
        x, a1, scale, bias, dy = ln_inputs(dtype, kind, rows, d, seed=d)
        y, mean, rstd = LN.fused_ln_add_fwd_cuda(x, a1, scale, bias,
                                                 kind=kind)
        y_bare, none, _ = LN.fused_ln_add_fwd_cuda(x, a1, scale, bias,
                                                   kind=kind, stats=False)
        # a row's bits do not depend on the row count (nor on its block)
        few = [LN.fused_ln_add_fwd_cuda(x[:k], a1[:k], scale, bias,
                                        kind=kind, stats=False)[0]
               for k in (min(8, rows), 1)]
        rows_same = all(torch.equal(f, y[:f.shape[0]]) for f in few)
        stats_same = torch.equal(y_bare, y) and none is None

        def leaves():
            return [None if t is None else
                    t.detach().clone().requires_grad_(True)
                    for t in (x, a1, scale, bias)]
        px, pa, ps, pb = leaves()
        ref = LN.ln_add_plain(px, pa, ps, pb, kind=kind)
        ref.backward(dy)
        kx, ka, ks, kb = leaves()
        LN.FusedLnAdd.apply(kx, ka, ks, kb, kind, 1e-6).backward(dy)
        pairs = [(kx, px), (ks, ps)] + ([(kb, pb)] if bias is not None
                                        else [])
        again = LN.fused_ln_add_bwd_cuda(dy, x, scale, mean, rstd, kind=kind)
        same = torch.equal(again[0], kx.grad) and torch.equal(again[1],
                                                              ks.grad)
        torch.cuda.synchronize()
        # fp32: one rounding apart; bf16: the kernel and the plain version
        # both round LN(x) + a1n once, from fp32 values a few fp32 ulps
        # apart: at most one bf16 ulp
        tol_y = 1e-5 if dtype == torch.float32 else bf16_ulp(ref)
        e_y = max_err(y, ref)
        e_g = max(rel_err(k.grad, p.grad) for k, p in pairs)
        e_a = max_err(ka.grad, dy)
        tol_g = 1e-5 if dtype == torch.float32 else 2e-2
        name = f"{kind} ({rows}, {d}) {str(dtype)[6:]}"
        print(f"  {name}: y {e_y:.3e} (tol {tol_y:.3g}); dx, dscale"
              f"{', dbias' if bias is not None else ''} vs autograd through "
              f"the plain version {e_g:.3e} (relative, tol {tol_g:g}); "
              f"d(a1n) == dy {e_a == 0}; two backward runs bit-identical "
              f"{same}; y without the statistics bit-identical "
              f"{stats_same}; rows of 8- and 1-row calls bit-identical "
              f"{rows_same}", flush=True)
        require(e_y <= tol_y, f"{name}: forward disagrees")
        require(stats_same, f"{name}: y differs without the statistics")
        require(rows_same, f"{name}: a row's bits depend on the row count")
        require(e_g <= tol_g, f"{name}: backward disagrees")
        require(e_a == 0 and same, f"{name}: d(a1n) or determinism")
        if (kind, rows, d) == ("rmsnorm", 2048, 3072) \
                and dtype == torch.bfloat16:
            errs = {"fused_ln_add": e_y, "fused_ln_add.bwd": e_g}
    return errs


def _flash_bound_ms(B, S, h, hkv, d, elt, bw, factor=1.0, n_io=4,
                    pairs=None):
    """Least time of a causal attention pass: flops 4 * D per visible
    (query, key) pair per head (``pairs``, default S (S + 1) / 2), times
    ``factor`` (the backward: 2.5), at 989 TFLOP/s; bytes: ``n_io``
    (B, S, H, D) tensors of q's size (K and V count at Hkv / H of it) read
    or written once, plus the fp32 row statistics."""
    pairs = S * (S + 1) / 2 if pairs is None else pairs
    flops = 4 * d * h * B * pairs * factor
    nbytes = n_io * B * S * h * d * elt + 2 * B * h * S * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def train_time_phase(bw):
    """Kernel, plain, bound and library times of the four training kernels
    at the training shapes of llama3.2-3b (bf16; B=1, S=2048)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_ln_add as LN
    phase("kernel time: flash_attention and fused_ln_add, fwd and bwd")
    rows = {}
    _, B, S, h, hkv, d, _ = FLASH_SHAPES[0]
    q, k, v, do = flash_inputs(torch.bfloat16, B, S, h, hkv, d, seed=1)
    o, lse = FA.flash_attention_fwd_cuda(q, k, v)
    shape = f"B={B} S={S} H={h} Hkv={hkv} D={d} causal bf16"
    fwd_ms = _median_ms(lambda: FA.flash_attention_fwd_cuda(q, k, v), n=30)
    bwd_ms = _median_ms(lambda: FA.flash_attention_bwd_cuda(
        q, k, v, o, lse, do), n=30)
    fwd_plain = _median_ms(lambda: FA.flash_attention_plain(q, k, v), n=10)
    bwd_plain = _median_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, o, lse, do), n=10)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib_fwd = _median_ms(sdpa, n=30)
    out = sdpa()
    dot = do.transpose(1, 2)
    lib_bwd = _median_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), n=30)
    lib_both = _median_ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), n=30)
    elt = q.element_size()
    b_fwd = _flash_bound_ms(B, S, h, hkv, d, elt, bw,
                            n_io=2 + 2 * hkv / h)
    b_bwd = _flash_bound_ms(B, S, h, hkv, d, elt, bw, factor=2.5,
                            n_io=4 + 4 * hkv / h)
    rows["flash_attention"] = dict(ms=fwd_ms, plain_ms=fwd_plain,
                                   bound_ms=b_fwd[0], bound_by=b_fwd[1],
                                   library_ms=lib_fwd, shape=shape)
    rows["flash_attention.bwd"] = dict(
        ms=bwd_ms, plain_ms=bwd_plain, bound_ms=b_bwd[0],
        bound_by=b_bwd[1], library_ms=lib_bwd, library_fwd_bwd_ms=lib_both,
        shape=shape + "; bound at 2.5x the forward's flops")
    flops = 4 * d * h * B * S * (S + 1) / 2
    print(f"  flash_attention {shape}: kernel_ms {fwd_ms:.4f} plain_ms "
          f"{fwd_plain:.4f} bound_ms {b_fwd[0]:.4f} ({b_fwd[1]}) "
          f"library_ms {lib_fwd:.4f} (scaled_dot_product_attention, "
          f"enable_gqa); {flops / fwd_ms / 1e9:.1f} TFLOP/s, "
          f"{b_fwd[0] / fwd_ms:.3f} of the bound")
    print(f"  flash_attention.bwd: kernel_ms {bwd_ms:.4f} plain_ms "
          f"{bwd_plain:.4f} bound_ms {b_bwd[0]:.4f} ({b_bwd[1]}) "
          f"library_ms {lib_bwd:.4f} (SDPA's backward alone; forward + "
          f"backward {lib_both:.4f}); {2.5 * flops / bwd_ms / 1e9:.1f} "
          f"TFLOP/s (at 2.5x the forward's flops), {b_bwd[0] / bwd_ms:.3f} "
          f"of the bound", flush=True)
    del qt, kt, vt, out
    rows["flash_attention"].update(flash_gemma2_times(bw))
    rows["flash_attention.bwd"].update(rows["flash_attention"].pop("bwd"))
    rows["flash_attention"].update(flash_mla_times(bw))
    rows["flash_attention.bwd"].update(rows["flash_attention"].pop("bwd"))
    rows["flash_attention"].update(flash_whisper_times(bw))
    rows["flash_attention.bwd"].update(rows["flash_attention"].pop("bwd"))
    for kind, n, dm in LN_SHAPES[:LN_TIMED]:
        x, a1, scale, bias, dy = ln_inputs(torch.bfloat16, kind, n, dm, 2)
        y, mean, rstd = LN.fused_ln_add_fwd_cuda(x, a1, scale, bias,
                                                 kind=kind)
        # the wrappers' host work (three or four allocations; the
        # backward also asks the card's SM count) is close to the flush's
        # at small shapes: timed with a lead (device time) and, as before
        # the backward's redesign, without
        f_ms = _median_ms(lambda: LN.fused_ln_add_fwd_cuda(
            x, a1, scale, bias, kind=kind), lead_cycles=LEAD_CYCLES)
        f_no_lead = _median_ms(lambda: LN.fused_ln_add_fwd_cuda(
            x, a1, scale, bias, kind=kind))
        # the serving route: no statistics
        f_bare = _median_ms(lambda: LN.fused_ln_add_fwd_cuda(
            x, a1, scale, bias, kind=kind, stats=False),
            lead_cycles=LEAD_CYCLES)
        f_clean = _median_ms(lambda: LN.fused_ln_add_fwd_cuda(
            x, a1, scale, bias, kind=kind), lead_cycles=LEAD_CYCLES,
            clean=True)
        b_ms = _median_ms(lambda: LN.fused_ln_add_bwd_cuda(
            dy, x, scale, mean, rstd, kind=kind), lead_cycles=LEAD_CYCLES)
        b_no_lead = _median_ms(lambda: LN.fused_ln_add_bwd_cuda(
            dy, x, scale, mean, rstd, kind=kind))
        # the same after a flush that leaves no dirty lines to write back
        b_clean = _median_ms(lambda: LN.fused_ln_add_bwd_cuda(
            dy, x, scale, mean, rstd, kind=kind), lead_cycles=LEAD_CYCLES,
            clean=True)
        f_plain = _median_ms(lambda: LN.ln_add_plain(x, a1, scale, bias,
                                                     kind=kind))
        xr = x.detach().requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        ref = LN.ln_add_plain(xr, a1, sr, bias, kind=kind)
        b_plain = _median_ms(lambda: torch.autograd.grad(
            ref, (xr, sr), dy, retain_graph=True))
        w = scale.to(x.dtype)
        if kind == "rmsnorm":
            unfused = _median_ms(lambda: F.rms_norm(x, (dm,), w, 1e-6) + a1)
        else:
            bb = bias.to(x.dtype)
            unfused = _median_ms(lambda: F.layer_norm(x, (dm,), w, bb, 1e-6)
                                 + a1)
        # bytes: x and a1n (dy and x) read, y (dx) written, the (rows,)
        # fp32 statistics, and the (d,) fp32 scale (bias) and gradients
        elt, ln = x.element_size(), int(kind == "layernorm")
        fb = (3 * n * dm * elt + (1 + ln) * dm * 4 + 8 * n) / bw * 1e3
        bb_ = (3 * n * dm * elt + (2 + ln) * dm * 4 + 8 * n) / bw * 1e3
        shape = f"({n}, {dm}) {kind} bf16"
        torch_norm = "rms_norm" if kind == "rmsnorm" else "layer_norm"
        print(f"  fused_ln_add {shape}: kernel_ms {f_ms:.4f} (without "
              f"the lead {f_no_lead:.4f}; without the statistics "
              f"{f_bare:.4f}; after a read flush {f_clean:.4f}) plain_ms {f_plain:.4f} bound_ms "
              f"{fb:.4f} (bytes, {fb / f_ms:.2f} of it) library_ms none (no "
              f"single call); unfused_ms {unfused:.4f} (F.{torch_norm} + "
              f"add); before the redesign "
              f"{LN_FWD_BEFORE_MS.get((kind, n, dm), 'not measured')} ms "
              f"(PERF.md, with a lead, NVIDIA H100 80GB HBM3, 700.00 W)")
        print(f"  fused_ln_add.bwd {shape}: kernel_ms {b_ms:.4f} (without "
              f"the lead {b_no_lead:.4f}; after a read flush, no "
              f"write-back, {b_clean:.4f}) plain_ms {b_plain:.4f} (autograd "
              f"through the plain version) bound_ms {bb_:.4f} (bytes, "
              f"{bb_ / b_ms:.2f} of it); before the redesign "
              f"{LN_BWD_BEFORE_MS.get((kind, n, dm), 'not measured')} ms "
              f"(PERF.md, without a lead, NVIDIA H100 80GB HBM3, 700.00 W)",
              flush=True)
        fwd = dict(ms=f_ms, plain_ms=f_plain, bound_ms=fb, bound_by="bytes",
                   library_ms=None, unfused_ms=unfused, no_lead_ms=f_no_lead,
                   nostats_ms=f_bare, clean_flush_ms=f_clean, shape=shape)
        bwd = dict(ms=b_ms, plain_ms=b_plain, bound_ms=bb_, bound_by="bytes",
                   library_ms=None, no_lead_ms=b_no_lead,
                   clean_flush_ms=b_clean, shape=shape)
        if (kind, n, dm) == LN_SHAPES[0]:
            # where the backward's time goes: its two kernels' device times
            bwd["kernels_us"] = kernel_breakdown(
                lambda: LN.fused_ln_add_bwd_cuda(dy, x, scale, mean, rstd,
                                                 kind=kind))
            print("  fused_ln_add.bwd kernels (torch.profiler, mean of 20 "
                  "calls; the column sums, a programmatic dependent, "
                  "include their wait): " + ", ".join(
                      f"{k} {v:.2f} us" for k, v in
                      bwd["kernels_us"].items()), flush=True)
            rows["fused_ln_add"], rows["fused_ln_add.bwd"] = fwd, bwd
        else:
            # the other timed shapes ride along in the main rows
            tag = f"{kind}_{n}x{dm}"
            rows["fused_ln_add"].update({f"{tag}_ms": f_ms,
                                         f"{tag}_nostats_ms": f_bare,
                                         f"{tag}_clean_flush_ms": f_clean,
                                         f"{tag}_bound_ms": fb,
                                         f"{tag}_unfused_ms": unfused})
            rows["fused_ln_add.bwd"].update({f"{tag}_ms": b_ms,
                                             f"{tag}_bound_ms": bb_})
    return rows


def flash_gemma2_times(bw):
    """The capped, windowed flash kernels at gemma2-27b's training shape
    (B=1, S=6144, H=32, Hkv=16, D=128, window 4096, cap 50, bf16): kernel,
    plain and bound times, forward and backward; also with the window alone
    (the softcap's cost).  No PyTorch call applies a logit softcap: no
    library time.  Returns the forward's fields, the backward's under
    "bwd"."""
    from repro_torch.kernels import flash_attention as FA
    B, S, h, hkv, d = G2_TRAIN_B, G2_TRAIN_S, G2_H, G2_HKV, G2_D
    q, k, v, do = flash_inputs(torch.bfloat16, B, S, h, hkv, d, seed=2)
    kw = dict(window=G2_WINDOW, cap=G2_CAP)
    bare = dict(window=G2_WINDOW)
    o, lse = FA.flash_attention_fwd_cuda(q, k, v, **kw)
    o0, lse0 = FA.flash_attention_fwd_cuda(q, k, v, **bare)
    fwd_ms = _median_ms(lambda: FA.flash_attention_fwd_cuda(q, k, v, **kw),
                        n=30)
    bwd_ms = _median_ms(lambda: FA.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, **kw), n=30)
    fwd_nocap = _median_ms(lambda: FA.flash_attention_fwd_cuda(
        q, k, v, **bare), n=30)
    bwd_nocap = _median_ms(lambda: FA.flash_attention_bwd_cuda(
        q, k, v, o0, lse0, do, **bare), n=30)
    fwd_plain = _median_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                           n=5)
    bwd_plain = _median_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, o, lse, do, **kw), n=5)
    pairs = _flash_visible_pairs(S, S, True, 0, G2_WINDOW)
    elt = q.element_size()
    b_fwd = _flash_bound_ms(B, S, h, hkv, d, elt, bw, n_io=2 + 2 * hkv / h,
                            pairs=pairs)
    b_bwd = _flash_bound_ms(B, S, h, hkv, d, elt, bw, factor=2.5,
                            n_io=4 + 4 * hkv / h, pairs=pairs)
    shape = (f"B={B} S={S} H={h} Hkv={hkv} D={d} causal window "
             f"{G2_WINDOW} cap {G2_CAP:g} bf16, {pairs} visible pairs a "
             f"head ({S * (S + 1) // 2} causal)")
    flops = 4 * d * h * B * pairs
    print(f"  flash_attention gemma2 {shape}: kernel_ms {fwd_ms:.4f} "
          f"(window alone {fwd_nocap:.4f}) plain_ms {fwd_plain:.4f} "
          f"bound_ms {b_fwd[0]:.4f} ({b_fwd[1]}) library_ms none (no "
          f"PyTorch call applies a logit softcap); {flops / fwd_ms / 1e9:.1f}"
          f" TFLOP/s, {b_fwd[0] / fwd_ms:.3f} of the bound")
    print(f"  flash_attention.bwd gemma2: kernel_ms {bwd_ms:.4f} (window "
          f"alone {bwd_nocap:.4f}) plain_ms {bwd_plain:.4f} bound_ms "
          f"{b_bwd[0]:.4f} ({b_bwd[1]}); {2.5 * flops / bwd_ms / 1e9:.1f} "
          f"TFLOP/s (at 2.5x the forward's flops), "
          f"{b_bwd[0] / bwd_ms:.3f} of the bound", flush=True)
    return dict(gemma2_ms=fwd_ms, gemma2_window_only_ms=fwd_nocap,
                gemma2_plain_ms=fwd_plain, gemma2_bound_ms=b_fwd[0],
                gemma2_bound_by=b_fwd[1], gemma2_library_ms=None,
                gemma2_shape=shape,
                bwd=dict(gemma2_ms=bwd_ms, gemma2_window_only_ms=bwd_nocap,
                         gemma2_plain_ms=bwd_plain,
                         gemma2_bound_ms=b_bwd[0], gemma2_bound_by=b_bwd[1],
                         gemma2_library_ms=None, gemma2_shape=shape))


def _sdpa_fused_ms(q, k, v, do, causal=True):
    """(forward ms, backward ms) of ``scaled_dot_product_attention`` on
    (B, S, H, *) bf16 q, k, v of their own head widths, causal or not,
    through a fused backend only (flash, memory-efficient or cuDNN); (None,
    None) when none of them takes the shapes."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]

    def sdpa():
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
    try:
        out = sdpa()
        torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2),
                            retain_graph=True)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"  scaled_dot_product_attention: no fused backend takes "
              f"q / k {q.shape[-1]} and v {v.shape[-1]} wide ({str(e)[:120]})")
        return None, None
    dot = do.transpose(1, 2)
    return (_median_ms(sdpa, n=30),
            _median_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), n=30))


def flash_mla_times(bw):
    """The D = 192 flash kernels at deepseek-v3's training shape (B=1,
    S=2048, 128 heads, qk 128 + 64 = 192 wide, v 128 wide, causal, bf16):
    the kernels on v padded to 192 (what MLA launches), the wrapper's whole
    route (pad, kernel, slice), the plain versions at the unpadded width,
    and ``scaled_dot_product_attention`` where a fused backend takes v
    narrower than q.  Bound: 2 (192 + 128) flops a visible pair a head at
    989 TFLOP/s (the backward 2.5x), or the unpadded tensors' bytes.
    Returns the forward's fields, the backward's under "bwd"."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    _, B, S, h, hkv, d, dv, _ = FLASH_MLA_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k = randn(g, torch.bfloat16, B, S, h, d), \
        randn(g, torch.bfloat16, B, S, hkv, d)
    v, do = randn(g, torch.bfloat16, B, S, hkv, dv), \
        randn(g, torch.bfloat16, B, S, h, dv)
    pad = (0, d - dv)
    vp, dop = F.pad(v, pad), F.pad(do, pad)
    o, lse = FA.flash_attention_fwd_cuda(q, k, vp)
    fwd_ms = _median_ms(lambda: FA.flash_attention_fwd_cuda(q, k, vp), n=30)
    bwd_ms = _median_ms(lambda: FA.flash_attention_bwd_cuda(
        q, k, vp, o, lse, dop), n=30)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_attention(*leaves)
    route_fwd = _median_ms(lambda: FA.flash_attention(*leaves), n=30)
    route_bwd = _median_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), n=30)
    r_o, r_lse = FA.flash_attention_plain(q, k, v)
    fwd_plain = _median_ms(lambda: FA.flash_attention_plain(q, k, v), n=5)
    bwd_plain = _median_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, r_o, r_lse, do), n=5)
    lib_fwd, lib_bwd = _sdpa_fused_ms(q, k, v, do)
    pairs = S * (S + 1) / 2
    flops = 2 * (d + dv) * h * B * pairs
    fwd_bytes = B * S * h * (2 * d + 2 * dv) * 2 + B * h * S * 4
    bwd_bytes = B * S * h * (4 * d + 4 * dv) * 2 + 2 * B * h * S * 4
    bounds = []
    for fl, nb in ((flops, fwd_bytes), (2.5 * flops, bwd_bytes)):
        t_ops, t_bytes = fl / PEAK_BF16_FLOPS, nb / bw
        bounds.append((max(t_ops, t_bytes) * 1e3,
                       "operations" if t_ops >= t_bytes else "bytes"))
    shape = (f"B={B} S={S} H={h} Hkv={hkv} qk D={d} v Dv={dv} (padded to "
             f"{d} for the kernel) causal bf16")
    lib = (lambda x: "none (no fused SDPA backend takes these widths)"
           if x is None else f"{x:.4f}")
    print(f"  flash_attention MLA {shape}: kernel_ms {fwd_ms:.4f} (the "
          f"wrapper's pad + kernel + slice {route_fwd:.4f}) plain_ms "
          f"{fwd_plain:.4f} bound_ms {bounds[0][0]:.4f} ({bounds[0][1]}) "
          f"library_ms {lib(lib_fwd)}; {flops / fwd_ms / 1e9:.1f} TFLOP/s "
          f"of unpadded work, {bounds[0][0] / fwd_ms:.3f} of the bound")
    print(f"  flash_attention.bwd MLA: kernel_ms {bwd_ms:.4f} (the route "
          f"{route_bwd:.4f}) plain_ms {bwd_plain:.4f} bound_ms "
          f"{bounds[1][0]:.4f} ({bounds[1][1]}) library_ms {lib(lib_bwd)}; "
          f"{2.5 * flops / bwd_ms / 1e9:.1f} TFLOP/s, "
          f"{bounds[1][0] / bwd_ms:.3f} of the bound", flush=True)
    return dict(mla_ms=fwd_ms, mla_route_ms=route_fwd,
                mla_plain_ms=fwd_plain, mla_bound_ms=bounds[0][0],
                mla_bound_by=bounds[0][1], mla_library_ms=lib_fwd,
                mla_shape=shape,
                bwd=dict(mla_ms=bwd_ms, mla_route_ms=route_bwd,
                         mla_plain_ms=bwd_plain, mla_bound_ms=bounds[1][0],
                         mla_bound_by=bounds[1][1], mla_library_ms=lib_bwd,
                         mla_shape=shape + "; bound at 2.5x the forward's "
                         "flops"))


def flash_whisper_times(bw):
    """The flash kernels at whisper-small's shapes (FLASH_WHISPER_SHAPES at
    B = WHISPER_TIMED_B, bf16, no mask): kernel, plain and
    ``scaled_dot_product_attention`` (a fused backend) times; the backward
    at the two training shapes (a decode step has none).  Bound: 4 D flops
    a (query, key) pair a head at 989 TFLOP/s (the backward 2.5x), or q, o
    (+ dO, dQ) of Sq rows and k, v (+ dK, dV) of Sk rows read or written
    once.  Returns the forward's fields, the backward's under "bwd", each
    keyed by the shape's short name."""
    from repro_torch.kernels import flash_attention as FA
    fwd, bwd = {}, {}
    for label, _, Sq, Sk, h, hkv, d in FLASH_WHISPER_SHAPES:
        B = WHISPER_TIMED_B
        key = "whisper_" + label.split(" ", 1)[1].replace(" ", "_")
        g = torch.Generator(device="cuda").manual_seed(7)
        q, do = (randn(g, torch.bfloat16, B, Sq, h, d) for _ in range(2))
        k, v = (randn(g, torch.bfloat16, B, Sk, hkv, d) for _ in range(2))
        o, lse = FA.flash_attention_fwd_cuda(q, k, v, causal=False)
        kw = dict(causal=False)
        f_ms = _median_ms(lambda: FA.flash_attention_fwd_cuda(q, k, v, **kw),
                          n=30)
        f_plain = _median_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                             n=5)
        lib_f, lib_b = _sdpa_fused_ms(q, k, v, do, causal=False)
        flops = 4 * d * h * B * Sq * Sk
        q_bytes, k_bytes = B * Sq * h * d * 2, B * Sk * hkv * d * 2
        stats = B * h * Sq * 4
        shape = f"B={B} Sq={Sq} Sk={Sk} H={h} Hkv={hkv} D={d} full bf16"
        rows = [("", fwd, f_ms, f_plain, lib_f, flops,
                 2 * q_bytes + 2 * k_bytes + stats)]
        if Sq > 1:
            b_ms = _median_ms(lambda: FA.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, **kw), n=30)
            r_o, r_lse = FA.flash_attention_plain(q, k, v, **kw)
            b_plain = _median_ms(lambda: FA.flash_attention_bwd_plain(
                q, k, v, r_o, r_lse, do, **kw), n=3)
            rows.append((".bwd", bwd, b_ms, b_plain, lib_b, 2.5 * flops,
                         4 * q_bytes + 4 * k_bytes + 2 * stats))
        for suffix, out, ms, plain_ms, lib, fl, nb in rows:
            t_ops, t_bytes = fl / PEAK_BF16_FLOPS, nb / bw
            bound = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            out.update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                        f"{key}_bound_ms": bound, f"{key}_bound_by": by,
                        f"{key}_library_ms": lib, f"{key}_shape": shape})
            lib_s = "none" if lib is None else f"{lib:.4f}"
            print(f"  flash_attention{suffix} {label} {shape}: kernel_ms "
                  f"{ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound:.4f} "
                  f"({by}) library_ms {lib_s} (scaled_dot_product_attention"
                  f"); {fl / ms / 1e9:.1f} TFLOP/s, {bound / ms:.3f} of the "
                  f"bound", flush=True)
        del q, k, v, do, o, lse
    fwd["bwd"] = bwd
    return fwd


def kernel_breakdown(fn, n=20):
    """{kernel name: mean device microseconds a call} of ``n`` calls of
    ``fn`` under torch.profiler (empty when it sees no CUDA kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    short = lambda k: re.sub(  # noqa: E731
        r"\(.*", "", k.split("(anonymous namespace)::")[-1])
    return {short(e.key): e.self_device_time_total / n
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


#: fused_ln_add's forward before its redesign (PERF.md section 6: the last
#: final run of the one-block-a-row kernel, with a lead), as text beside
#: the new times
LN_FWD_BEFORE_MS = {("rmsnorm", 2048, 3072): "0.0222",
                    ("layernorm", 2048, 768): "0.0124",
                    ("rmsnorm", 263, 3072): "0.0092"}
#: fused_ln_add's backward before its redesign (PERF.md section 6), as text
#: beside the new times
LN_BWD_BEFORE_MS = {("rmsnorm", 2048, 3072): "0.0460",
                    ("layernorm", 2048, 768): "0.0442"}


def train_tick_phase():
    """One train step at llama3.2-3b full width (2 layers, fp32, B=1,
    S=256, fal, remat; B=2 until the ssm / hybrid / audio families' TP
    part joined phase 13a) on the card (kernels) against the CPU (plain
    versions) from the same weights and batch."""
    from repro_torch.configs.base import get_config
    phase("one train step at full width, 2 layers, fp32: card vs CPU")
    train_tick(get_config("llama3.2-3b").replace(n_layers=2,
                                                 dtype="float32"), 1, 256)


def train_tick(cfg, B, S, params=None, moe=False):
    """One train step of ``cfg`` (fp32) on B x S tokens on the card
    (kernels) against the CPU (plain versions) from the same weights
    (``params`` on the CPU, else drawn from seed 0) and batch: loss, grad
    norm and post-step params; the card's paths and launches.  ``moe``:
    the routing of both steps is compared (``route_flips``: only near ties
    may differ); the loss, norm and params gates stay whole."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    ocfg = adamw.AdamWConfig(lr=3e-4)
    cpu = tstep.init_state(0, cfg, ocfg, device="cpu", params=params)
    gpu = tstep.init_state(0, cfg, ocfg, params=adamw.map_tree(
        lambda t: t.detach().to("cuda"), cpu["params"]))
    before = dict(adamw.named_leaves(adamw.map_tree(
        lambda t: t.detach().clone(), cpu["params"])))
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32)}
    step = tstep.make_train_step(cfg, ocfg)
    ops.reset_dispatch_paths()
    ops.reset_launches()
    with routes_if(moe) as routes:
        _, m_gpu = step(gpu, {"tokens": batch["tokens"].cuda()})
        torch.cuda.synchronize()
        paths, counts = ops.dispatch_paths(), ops.launch_counts()
        _, m_cpu = step(cpu, batch)
    if moe:
        route_flips(routes, f"train step of {cfg.arch_id}")
    d_loss = abs(float(m_gpu["loss"]) - float(m_cpu["loss"]))
    d_norm = abs(float(m_gpu["grad_norm"]) - float(m_cpu["grad_norm"])) \
        / float(m_cpu["grad_norm"])
    after = dict(adamw.named_leaves(cpu["params"]))
    worst, n_far, n_all = 0.0, 0, 0
    for path, t in adamw.named_leaves(gpu["params"]):
        diff = (t.detach().cpu() - after[path].detach()).abs()
        worst = max(worst, diff.max().item())
        n_far += int((diff > 1e-6).sum())
        n_all += diff.numel()
    moved = max((after[p].detach() - t).abs().max().item()
                for p, t in before.items())
    lr = 3e-4
    print(f"  loss card {float(m_gpu['loss']):.6f} CPU "
          f"{float(m_cpu['loss']):.6f} (|diff| {d_loss:.3e}, tol 1e-4); "
          f"grad_norm relative diff {d_norm:.3e} (tol 1e-4); post-step "
          f"params max |diff| {worst:.3e} (tol 2 lr = {2 * lr:g}: a first "
          f"AdamW step moves a weight by about lr times the sign of its "
          f"gradient), {n_far} of {n_all} weights differ by more than "
          f"1e-6 (tol 0.1%); largest step on the CPU {moved:.3e}; card "
          f"paths {paths}; launches {counts}", flush=True)
    require(paths == {"flash_attention": ops.CUDA,
                      "fused_ln_add": ops.CUDA},
            f"card train step paths {paths}")
    require(d_loss <= 1e-4 and d_norm <= 1e-4, "card train step loss or "
            "grad norm disagrees with the CPU")
    require(worst <= 2 * lr and n_far <= 1e-3 * n_all,
            "card post-step params disagree with the CPU")
    L = cfg.n_layers
    want = {"flash_attention": 2 * L, "flash_attention.bwd": L,
            "fused_ln_add": 2 * L, "fused_ln_add.bwd": L}
    require(all(counts[k] == n for k, n in want.items()),
            f"train step launches {counts} != {want} (remat: 2 x layers "
            f"forward, layers backward)")


def train_phase():
    """``trainer.train`` at llama3.2-3b full width and depth: fal, fp32
    masters, bf16 compute, remat, B=1, S=2048, one warm-up step and 5
    counted steps; then one more step under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train import trainer
    cfg = get_config("llama3.2-3b")
    steps, B, S = 6, 1, 2048
    phase(f"train: llama3.2-3b, {cfg.n_layers} layers, {cfg.connection}, "
          f"fp32 masters, {cfg.dtype} compute, remat {cfg.remat}, B={B}, "
          f"S={S}, {steps - 1} steps after 1 warm-up")
    marks = []

    def mark(i, state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if i == 0:                       # the warm-up step is not counted
            ops.reset_launches()
            ops.reset_dispatch_paths()
            torch.cuda.reset_peak_memory_stats()

    state, hist = trainer.train(cfg, steps=steps, batch=B, seq_len=S,
                                log_every=1, device="cuda", callbacks=[mark])
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms)
    print(f"  losses {['%.4f' % x for x in losses]}; step ms "
          f"{['%.1f' % x for x in step_ms]} (median {ms:.1f}); "
          f"{B * S / ms * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    n, L = steps - 1, cfg.n_layers
    # remat: block 0 and each later block run their forward twice (the
    # forward, then the recompute in the backward), the backward once
    want = {"flash_attention": n * L * 2, "flash_attention.bwd": n * L,
            "fused_ln_add": n * L * 2, "fused_ln_add.bwd": n * L}
    print(f"  launches {dict((k, counts[k]) for k in want)} (expected "
          f"steps x layers x remat factor 2 forward, steps x layers "
          f"backward: {want}); paths {paths}", flush=True)
    require(all(math.isfinite(x) for x in losses), "non-finite loss")
    require(all(counts[k] == v for k, v in want.items()),
            "train launches != their products")
    require(paths == {"flash_attention": ops.CUDA, "fused_ln_add": ops.CUDA},
            f"train paths {paths}")
    ocfg = adamw.AdamWConfig(lr=3e-4)
    step = tstep.make_train_step(cfg, ocfg)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), device="cuda")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0.0:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels)")
    else:
        print(f"  profiled step: wall {wall:.1f} ms, device kernel time "
              f"{device_ms:.1f} ms, busy share {device_ms / wall:.3f} "
              f"(of the profiled wall)")
        for key, kms, c in sorted(rows, key=lambda r: -r[1])[:10]:
            print(f"    {kms:9.2f} ms {c:6d} calls  {key[:90]}")
        # the flash_attention kernels (bf16: namespace tc, and the delta
        # pass), wherever they rank
        flash = [(re.search(r"(\w+<[^>]*>)\(", key).group(1), kms, c)
                 for key, kms, c in rows
                 if re.search(r"tc::\w+_kernel<|flash_\w+_kernel<", key)]
        flash_ms = sum(r[1] for r in flash)
        print(f"  flash_attention kernels: {flash_ms:.2f} ms of the step's "
              f"device time ({flash_ms / device_ms:.3f}): " + ", ".join(
                  f"{name} {kms:.2f} ms in {c}" for name, kms, c in flash))
    sys.stdout.flush()
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      adamw.named_leaves({"params": state["params"],
                                          "m": state["opt"]["m"],
                                          "v": state["opt"]["v"]}))
    return {k: counts[k] for k in want}, dict(
        step_ms=ms, peak=peak, state_bytes=state_bytes, B=B, S=S,
        steps=steps)


# --------------------------------------------------------------------------- #
# the dry run against the card
# --------------------------------------------------------------------------- #
#: the dry run's predicted peak against train_phase's max_memory_allocated
DRYRUN_PEAK_RTOL = 0.05


def check_meta_workspaces():
    """The meta route's workspace sizes (Python mirrors of the sources'
    layouts) against the built libraries' own sizing functions, over
    edge shapes: equal bytes, or the gate fails."""
    from repro_torch.kernels import dual_branch as DB
    from repro_torch.kernels import paged_attention as PA
    lib, dlib = PA._lib(), DB._lib()
    n = 0
    for (H, Hkv, D), page, Tb, rows, kv in itertools.product(
            ((24, 8, 128), (32, 8, 64), (8, 8, 32), (16, 2, 128)), (4, 16),
            (1, 4, 16, 64, 130), (1, 8, 263), (1, 2, 3)):
        want = (lib.paged_packed_workspace_bytes(rows, H, Hkv, D, page, Tb,
                                                 1, kv),
                lib.paged_decode_workspace_bytes(rows, H, Hkv, D, page, Tb,
                                                 1, kv),
                lib.paged_chunk_workspace_bytes(rows, 37, H, Hkv, D, page,
                                                Tb, 1, kv))
        got = (PA.packed_workspace_size(rows, H, Hkv, D, page, Tb),
               PA.decode_workspace_size(rows, H, D, page, Tb),
               PA.chunk_workspace_size(rows, 37, H, Hkv, D, page, Tb))
        require(got == want, f"meta workspaces {got} != the library's {want}"
                f" at H={H} Hkv={Hkv} D={D} page={page} Tb={Tb} rows={rows} "
                f"kv_type={kv}")
        for Dm, F, bf16 in ((3072, 8192, 1), (128, 200, 1), (128, 256, 0)):
            want = dlib.fused_dual_branch_workspace_bytes(
                rows, H, Hkv, D, page, Tb, Dm, F, bf16, bf16)
            got = DB.workspace_size(rows, H, D, page, Tb, Dm, F, bf16, bf16)
            require(got == want, f"meta dual workspace {got} != {want}")
        n += 1
    print(f"  meta-route workspaces equal the libraries' sizing at {n} "
          f"shapes (packed, decode, chunk, dual)", flush=True)


def dryrun_phase(train):
    """``launch/dryrun.py``'s ``lower_pair`` at model 1 x data 1 for
    train_phase's own workload (llama3.2-3b, full depth, fp32 masters, bf16
    compute, remat, B = 1, S = 2048), run on the ``meta`` device (no
    card), held against the numbers train_phase measured on the card: its
    state's bytes, its ``max_memory_allocated`` and its step time."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    B, S = train["B"], train["S"]
    phase(f"dry run (meta device) of the train phase's workload: "
          f"llama3.2-3b, B={B}, S={S}, model 1 x data 1")
    check_meta_workspaces()
    info = DR.lower_pair("llama3.2-3b", ShapeConfig("train_phase", S, B,
                                                    "train"), DR.Mesh(1, 1, 1))
    mem, gib = info["memory"], 2 ** 30
    batch_bytes = B * S * 4                  # the trainer's int32 tokens
    arg_want = train["state_bytes"] + batch_bytes
    peak, measured = mem["peak_bytes"], train["peak"]
    err = (peak - measured) / measured
    transient, measured_transient = peak - mem["argument_bytes"], \
        measured - arg_want
    tflops = info["cost"]["flops"] / (train["step_ms"] * 1e-3) / 1e12
    print(f"  traced in {info['trace_s']:.2f} s on the host; argument bytes "
          f"{mem['argument_bytes']} ({mem['argument_bytes'] / gib:.3f} GiB; "
          f"the card's state {train['state_bytes']} + tokens "
          f"{batch_bytes}); peak predicted {peak / gib:.3f} GiB vs "
          f"max_memory_allocated {measured / gib:.3f} GiB ({err:+.4f}); "
          f"transient (peak - arguments) predicted "
          f"{transient / gib:.3f} GiB vs measured "
          f"{measured_transient / gib:.3f} GiB, the card's extra "
          f"{(measured - peak) / 2**20:.1f} MiB (the tracker sees no "
          f"allocator rounding and no cuBLAS workspace); flops "
          f"{info['cost']['flops']:.4g} a step "
          f"({info['cost']['kernel_flops']:.4g} in the kernels' meta "
          f"counts) over the measured "
          f"{train['step_ms']:.1f} ms: {tflops:.1f} TFLOP/s", flush=True)
    require(mem["argument_bytes"] == arg_want,
            f"dry-run arguments {mem['argument_bytes']} != the card's "
            f"state + tokens {arg_want}")
    require(abs(err) <= DRYRUN_PEAK_RTOL,
            f"dry-run peak {peak} vs measured {measured}: {err:+.4f}")
    require(info["dispatch_paths"] == {"flash_attention": "meta-shape",
                                       "fused_ln_add": "meta-shape"},
            f"dry-run paths {info['dispatch_paths']}")
    return dict(peak=peak, measured=measured, rel_err=err, tflops=tflops,
                flops=info["cost"]["flops"], trace_s=info["trace_s"])


# --------------------------------------------------------------------------- #
# the examples on the card
# --------------------------------------------------------------------------- #
#: each example twin and the kernels its run must launch (its own process;
#: the quickstart's TP ranks count apart), as the first run on the card
#: launched them; the serving example's dual engine runs the packed layout,
#: whose attention and FFN are two ops, so fused_dual_branch_decode is not
#: among them
EXAMPLES = {
    "torch_train_fal_vs_baseline": ("flash_attention", "flash_attention.bwd",
                                    "fused_ln_add", "fused_ln_add.bwd"),
    "torch_quickstart": ("flash_attention", "flash_attention.bwd",
                         "fused_ln_add", "fused_ln_add.bwd"),
    "torch_serve_requests": ("paged_packed_attention",
                             "paged_packed_attention.int8", "fused_ln_add",
                             "page_copy"),
}
EXAMPLE_TIMEOUT = 600
_EXAMPLE_MAIN = """
import json, runpy, sys
sys.argv = [sys.argv[1]]
from repro_torch.kernels import ops
main = runpy.run_path(sys.argv[0], run_name="example")["main"]
out = main([])
print("EXAMPLE " + json.dumps({
    "launches": ops.launch_counts(), "paths": ops.dispatch_paths(),
    "rank_launches": (out or {}).get("rank_launches")}))
"""


def examples_phase():
    """The three example twins at their defaults, each in a process of its
    own, all started together, in a temporary working directory: each must
    exit 0 (its own asserts met), report ``cuda-kernel`` on every dispatch
    site and launch the kernels ``EXAMPLES`` names."""
    phase("examples on the card: " + ", ".join(EXAMPLES))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        procs = {}
        for name in EXAMPLES:
            log = open(os.path.join(tmp, f"{name}.log"), "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", _EXAMPLE_MAIN,
                 str(ROOT / "examples" / f"{name}.py")], cwd=tmp, env=env,
                stdout=log, stderr=subprocess.STDOUT), log)
        try:
            for name, (proc, log) in procs.items():
                try:
                    rc = proc.wait(timeout=max(
                        1.0, EXAMPLE_TIMEOUT - (time.perf_counter() - t0)))
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                log.close()
                with open(log.name) as f:
                    text = f.read()
                secs = time.perf_counter() - t0
                lines = [ln for ln in text.splitlines()
                         if ln.startswith("EXAMPLE ")]
                print(f"  {name}: exit {rc} after {secs:.1f} s; its "
                      f"output:\n    " + "\n    ".join(
                          ln[:200] for ln in text.splitlines()
                          if not ln.startswith("EXAMPLE ")), flush=True)
                require(rc == 0 and lines, f"{name} failed (exit {rc}):\n"
                        + text[-3000:])
                out[name] = json.loads(lines[-1][len("EXAMPLE "):])
        finally:
            for proc, log in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
    for name, want in EXAMPLES.items():
        got = out[name]
        launched = {k: n for k, n in got["launches"].items() if n}
        print(f"  {name}: launches {launched}; paths {got['paths']}"
              + (f"; rank 0's launches "
                 f"{ {k: n for k, n in got['rank_launches'].items() if n} }"
                 if got["rank_launches"] else ""), flush=True)
        require(got["paths"] and all(
            p == "cuda-kernel" for p in got["paths"].values()),
            f"{name}: dispatch paths {got['paths']}")
        require(all(got["launches"].get(k, 0) > 0 for k in want),
                f"{name}: expected launches of {want}, got {launched}")
    print(f"  examples: {time.perf_counter() - t0:.1f} s", flush=True)
    return {name: r["launches"] for name, r in out.items()}


# --------------------------------------------------------------------------- #
# tensor parallelism over torch.distributed
# --------------------------------------------------------------------------- #
#: llama3.2-3b at full width cut to 4 layers: the two ranks share one card,
#: and fal pays (L + 1) / (2 L) = 5/8 of preln's all-reduce bytes (S = 1024
#: since the ssm / hybrid / audio families joined the spawn; 2048 before)
TP_LAYERS, TP_SEQ, TP_STEPS, TP_SIZE = 4, 1024, 3, 2
#: padded decode tick of one steady-state block: (pos, n_valid) a lane and
#: Tb = 64 pages of 16 (the fused route needs F / tp % (Hkv / tp * Tb) == 0)
TP_TICK_LANES = ((0, 1), (15, 1), (16, 1), (300, 1), (511, 1), (100, 0),
                 (900, 1), (1000, 1))
TP_TICK_TB = 64
#: tolerances of the TP phase.  Logits (bf16 compute): each TP all-reduce
#: rounds two bf16 partial sums and their sum, where one device rounds the
#: full product once: differences of a few bf16 ulps in each of 4 blocks'
#: residual updates, reaching logits of order 1 through the final norm.
#: Losses and grad norms (fp32 masters, bf16 compute, 3 AdamW steps): the
#: same roundings, relative.  Decode tick (bf16): one block, a few ulps of
#: the output's largest magnitude.
TP_LOGIT_TOL = 0.25
TP_LOSS_TOL = 2e-3
TP_GNORM_RTOL = 2e-2
TP_TICK_ULPS = 8


def tp_config(connection="fal", **kw):
    from repro_torch.configs.base import get_config
    return get_config("llama3.2-3b").replace(n_layers=TP_LAYERS,
                                             connection=connection, **kw)


def _tp_tokens(cfg, device):
    g = torch.Generator().manual_seed(21)
    return torch.randint(0, cfg.vocab, (1, TP_SEQ), generator=g,
                         dtype=torch.int32).to(device)


def _tp_counts_run(group, dev, connection, sp):
    """Forward + backward + the step's gradient sum of ``connection`` under
    explicit TP (remat off, fp32 masters, bf16 compute) -> this rank's
    collective counts, and the no-grad forward's."""
    from repro_torch.core import tp
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.launch import mesh as MX
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = tp_config(connection, remat=False)
    plan = ExecutionPlan.from_group(group, tp="explicit", sp=sp)
    full = M.init_params(cfg, seed=1, device=dev, dtype=cfg.param_dtype)
    shard = MX.shard_params(full, cfg, plan.tp_rank, plan.tp_size)
    del full
    batch = {"tokens": _tp_tokens(cfg, dev)}
    tp.reset_collectives()
    with torch.no_grad():
        M.forward(shard, cfg, batch, plan)
    fwd = tp.collective_counts()
    for _, p in adamw.named_leaves(shard):
        p.requires_grad_(True)
    tp.reset_collectives()
    loss, _ = M.loss_fn(shard, cfg, batch, plan)
    loss.backward()
    M.tp_sync_grads(shard, cfg, plan)
    torch.cuda.synchronize(dev)
    return {"forward": fwd, "train": tp.collective_counts(),
            "loss": float(loss)}


def _tp_tick_case(dev):
    """One steady-state block of llama3.2-3b (bf16) and a cache with
    history: (cfg, block params, K/V pools, x, a1_sig, tables, pos,
    n_valid) on ``dev``."""
    from repro_torch import interop
    from repro_torch.models import blocks as BL
    cfg = tp_config()
    bt, num_pages = lane_tables([p + 1 for p, _ in TP_TICK_LANES], page=PAGE,
                                tb=TP_TICK_TB, seed=23)
    g = torch.Generator().manual_seed(24)
    block = BL.block_init(g, cfg, torch.bfloat16, "cpu")
    shape = (num_pages, PAGE, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {k: torch.randn(shape, generator=g).to(torch.bfloat16)
             for k in ("k", "v")}
    B = len(TP_TICK_LANES)
    x = torch.randn((B, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    sig = torch.randn((B, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    lanes = torch.tensor(TP_TICK_LANES, dtype=torch.int32)
    return (cfg, *interop.tree_to(
        [block, cache, x, sig, bt, lanes[:, 0].contiguous(),
         lanes[:, 1].contiguous()], dev))


def tp_device(rank):
    """Rank r's card: r modulo the visible cards (gloo: all on card 0 of
    one)."""
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def tp_rank(group, backend):
    """One rank of the TP phase (spawned by ``core.tp.run_ranks``): the
    one-device references first, then, with the launch and collective
    counters zeroed, the TP paths.  Returns numbers only."""
    import torch.distributed as dist
    from repro_torch.core import tp
    from repro_torch.core.plan import ExecutionPlan, Phase, local_kv_heads
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as MX
    from repro_torch.models import blocks as BL
    from repro_torch.models import model as M
    from repro_torch.train import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, size = dist.get_rank(), dist.get_world_size()
    dev = tp_device(rank)
    out = {"rank": rank, "device": str(dev)}
    plan = ExecutionPlan.from_group(group, tp="explicit")

    # one-device references: bf16 logits, the tick, and (rank 0) training
    cfg = tp_config()
    batch = {"tokens": _tp_tokens(cfg, dev)}
    full = M.init_params(cfg, seed=0, device=dev)
    with torch.no_grad():
        ref_logits = M.forward(full, cfg, batch)[0]
    shard = MX.shard_params(full, cfg, rank, size)
    del full
    tcfg, block, cache, x, sig, bt, pos, nv = _tp_tick_case(dev)
    ref_tick = {}
    for dual in (False, True):
        one = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            ref_tick[dual] = BL.block_apply(
                block, tcfg, x, sig, cache=one, block_tables=bt, pos=pos,
                n_valid=nv, plan=ExecutionPlan.single_device(Phase.PAGED,
                                                             dual))[0]
    serve_cases, serve_ref = tp_serve_refs(dev, rank)
    torch.cuda.empty_cache()
    fam_refs = tp_family_refs(dev, rank, size)
    marks = []

    def mark(i, state, metrics):
        torch.cuda.synchronize(dev)
        marks.append(time.perf_counter())

    if rank == 0:
        _, hist = trainer.train(tp_config(remat=True), steps=TP_STEPS,
                                batch=1, seq_len=TP_SEQ, log_every=1,
                                device=dev, callbacks=[mark])
        out["one_device_train"] = [(h["loss"], h["grad_norm"]) for h in hist]
        out["one_device_step_ms"] = [(b - a) * 1e3 for a, b in
                                     zip(marks, marks[1:])]
        marks.clear()
        torch.cuda.empty_cache()
    dist.barrier()             # the TP parts start together on every rank

    # the TP paths, every counter from 0
    ops.reset_launches()
    ops.reset_dispatch_paths()
    launches = {}

    def part(name, fn):
        ops.reset_launches()
        tp.reset_collectives()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches[name] = {k: v for k, v in ops.launch_counts().items() if v}
        out[name] = dict(res or {}, ms=ms, counts=tp.collective_counts())

    def forward():
        with torch.no_grad():
            logits = M.forward(shard, cfg, batch, plan)[0]
        return {"logit_err": max_err(logits, ref_logits),
                "logit_top": ref_logits.float().abs().max().item(),
                "logit_sum": logits.float().sum().item()}
    part("forward", forward)
    del ref_logits

    def train():
        _, hist = trainer.train(tp_config(remat=True), steps=TP_STEPS,
                                batch=1, seq_len=TP_SEQ, log_every=1,
                                plan=plan, device=dev, callbacks=[mark])
        return {"hist": [(h["loss"], h["grad_norm"]) for h in hist]}
    part("train", train)
    out["train"]["step_ms"] = [(b - a) * 1e3 for a, b in
                               zip(marks, marks[1:])]
    torch.cuda.empty_cache()
    for connection in ("fal", "preln"):
        for sp in (False, True):
            part(f"{connection}{'_sp' if sp else ''}",
                 lambda: _tp_counts_run(group, dev, connection, sp))
            torch.cuda.empty_cache()
    # MLA (deepseek-v3 at full width, MLA_TP_LAYERS layers, fp32): the
    # sharded forward's logits against one device's
    mcfg = mla_config(n_layers=MLA_TP_LAYERS, dtype="float32")
    mbatch = {"tokens": _tp_tokens(mcfg, dev)[:, :MLA_TP_SEQ]}
    mfull = M.init_params(mcfg, seed=0, device=dev, dtype="float32")
    with torch.no_grad():
        mref = M.forward(mfull, mcfg, mbatch)[0]
    mshard = MX.shard_params(mfull, mcfg, rank, size)
    del mfull
    torch.cuda.empty_cache()

    def mla():
        with torch.no_grad():
            logits = M.forward(mshard, mcfg, mbatch, plan)[0]
        return {"logit_err": max_err(logits, mref),
                "logit_top": mref.float().abs().max().item()}
    part("mla", mla)
    del mshard, mref
    torch.cuda.empty_cache()
    hk = local_kv_heads(tcfg, size)
    tblock = MX.shard_params(block, tcfg, rank, size)
    ticks = {}
    for dual in (False, True):
        _, step = tp.make_tp_decode_step(group, tcfg, dual=dual,
                                         page_size=PAGE, device=dev)
        local = {k: v[:, :, rank * hk:(rank + 1) * hk].clone()
                 for k, v in cache.items()}

        def tick():
            with torch.no_grad():
                ticks[dual] = step(tblock, x, local, bt, pos, nv, sig)[0]
            ref = ref_tick[dual]
            return {"err": max_err(ticks[dual], ref),
                    "ulp": bf16_ulp(ref)}
        part("dual_tick" if dual else "tick", tick)
    out["dual_vs_sequential"] = max_err(ticks[True], ticks[False])
    del tblock
    torch.cuda.empty_cache()
    tp_serve_parts(group, dev, serve_cases, serve_ref, part, out)
    del serve_cases, serve_ref
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["paths"] = ops.dispatch_paths()
    # what one activation all-reduce of the training path costs here
    # (1 x S x d_model bf16, staged through host memory under gloo)
    act = torch.randn((1, TP_SEQ, cfg.d_model), device=dev,
                      dtype=torch.bfloat16)
    times = []
    for _ in range(6):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tp.assemble(act, group)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out["all_reduce_ms"] = statistics.median(times[1:])
    out["all_reduce_bytes"] = act.numel() * act.element_size()
    del act
    out["family"] = tp_family_parts(group, dev, fam_refs)
    return out


# --------------------------------------------------------------------------- #
# tensor parallelism in the serving ticks (inside tp_rank's spawn)
# --------------------------------------------------------------------------- #
#: padded ticks of the TP serving check: (pos, n_valid) a lane for one
#: C = TP_SERVE_C chunk tick over a random history, then one C == 1 dual
#: tick at pos + n_valid; Tb = 64 pages of 16 (the fused route needs F / tp
#: % (Hkv / tp * Tb) == 0)
TP_SERVE_LANES = ((0, 16), (15, 16), (100, 9), (300, 1), (511, 16),
                  (700, 0), (900, 16), (1000, 5))
TP_SERVE_C = 16
#: fp32 TP ticks against one device: the ranks sum half the heads / FFN
#: columns and then the halves, one device all at once (fp32 rounding of
#: 4 blocks' residual updates), relative to max(1, max |logit|)
TP_SERVE_FP32_TOL = 1e-3
#: the int8 tick against one device.  TP computes K / V from the
#: one-device residual stream up to fp32 rounding (cuBLAS, block 0
#: included, reduces a 512-column shard in another order than the
#: 1024-column whole), which flips a code by one step where a row lands
#: near a rounding boundary; a flipped code moves the next layers'
#: attention, so later rows' amax and scales move by more (on an H100 80GB
#: HBM3 at 700 W: 5.0e-4 relative at most, 0.011% of the codes one step
#: off).  The scatter alone, on the same rows, must be byte-exact
TP_SERVE_SCALE_RTOL = 1e-3
TP_SERVE_CODES_FRAC = 1e-3
TP_SERVE_NEW = 8
TP_SERVE_SEED = 3


def tp_serve_params(dev, dtype):
    """llama3.2-3b at full width and TP_LAYERS layers: weights in
    ``dtype`` (norms fp32), drawn from one seed on the card."""
    from repro_torch.models import model as M
    cfg = tp_config(dtype=dtype)
    return cfg, M.init_params(cfg, seed=TP_SERVE_SEED, device=dev)


def tp_serve_workload(vocab):
    """8 greedy requests: a donor parks a 4-page system prompt; then its
    verbatim repeat (a full-prompt hit: one copy-on-write), three
    extensions of it and three fresh prompts."""
    import numpy as np
    rng = np.random.default_rng(31)
    sysp = rng.integers(0, vocab, 4 * PAGE)
    later = [sysp.copy()]
    later += [np.concatenate([sysp, rng.integers(0, vocab, int(n))])
              for n in (5, 17, 33)]
    later += [rng.integers(0, vocab, int(n)) for n in (20, 47, 90)]
    return [[(0, sysp)], list(enumerate(later, start=1))]


def tp_serve_engine(cfg, params, dev, plan=None):
    """The workload through ``PagedEngine`` (prefix cache on) -> (streams,
    stats, per-call (sum, max) all-reduce counts)."""
    from repro_torch.core import tp
    from repro_torch.serve.scheduler import (EngineConfig, PagedEngine,
                                             ServeRequest)
    ecfg = EngineConfig(page_size=PAGE, num_pages=64, slots=4,
                        prefill_chunk=64, max_seq=256,
                        cache_dtype=cfg.dtype, prefix_cache=True)
    eng = PagedEngine(cfg, params, ecfg, plan=plan, device=dev)
    calls, run_packed = [], eng._run_packed

    def counted(pt):
        before = tp.collective_counts()
        run_packed(pt)
        after = tp.collective_counts()
        calls.append(tuple(tp.count(after, k) - tp.count(before, k)
                           for k in ("all-reduce", "all-reduce-max")))
    eng._run_packed = counted
    for reqs in tp_serve_workload(cfg.vocab):
        for rid, prompt in reqs:
            eng.submit(ServeRequest(rid=rid, prompt=prompt,
                                    max_new=TP_SERVE_NEW))
        eng.run()
    st = eng.stats()
    return ({r.rid: list(map(int, r.generated)) for r in eng.finished},
            {"ticks": st["ticks"], "calls": st["packed_calls"],
             "cow": st["prefix"]["cow_copies"],
             "hit_rate": st["prefix"]["hit_rate"]}, calls)


def tp_serve_cases(cfg, dev):
    """The fp32 ticks' inputs on ``dev``: a packed tick (``mixed_tick``)
    and the padded lanes, each with a random full-head cache."""
    from repro_torch import interop
    from repro_torch.models import model as M
    g = torch.Generator().manual_seed(41)
    bt, tok_slot, tok_pos, seg_last = mixed_tick(page=PAGE, num_pages=512,
                                                 tb=72, seed=5)
    tokens = torch.randint(0, cfg.vocab, tok_slot.shape, generator=g,
                           dtype=torch.int32)
    packed = dict(tokens=tokens, tok_slot=tok_slot, tok_pos=tok_pos,
                  block_tables=bt, seg_last=seg_last)
    pcache = M.init_paged_cache(cfg, 512, PAGE, seg_last.numel(), "float32",
                                device="cpu")
    random_history(pcache, g)
    pbt, n_pages = lane_tables([p + TP_SERVE_C + 1 for p, _ in
                                TP_SERVE_LANES], page=PAGE, tb=64, seed=43)
    dcache = M.init_paged_cache(cfg, n_pages, PAGE, len(TP_SERVE_LANES),
                                "float32", device="cpu")
    random_history(dcache, g)
    pos = torch.tensor([p for p, _ in TP_SERVE_LANES], dtype=torch.int32)
    nv = torch.tensor([n for _, n in TP_SERVE_LANES], dtype=torch.int32)
    chunk = dict(tokens=torch.randint(0, cfg.vocab, (len(pos), TP_SERVE_C),
                                      generator=g, dtype=torch.int32),
                 pos=pos, n_valid=nv, block_tables=pbt)
    one = dict(tokens=torch.randint(0, cfg.vocab, (len(pos), 1),
                                    generator=g, dtype=torch.int32),
               pos=pos + nv, n_valid=(nv > 0).to(torch.int32),
               block_tables=pbt)
    return interop.tree_to({"packed": [packed, pcache],
                            "padded": [chunk, one, dcache]}, dev)


def _heads_of(cache, rank, size):
    """This rank's KV heads of a full-head cache (scale pools and a1_sig
    whole)."""
    out = {}
    for part, leaves in cache.items():
        if not isinstance(leaves, dict):
            out[part] = leaves.clone()
            continue
        out[part] = {}
        for k, v in leaves.items():
            if k in ("k", "v"):
                hk = v.shape[-2] // size
                v = v[..., rank * hk:(rank + 1) * hk, :]
            out[part][k] = v.clone()
    return out


def tp_serve_ticks(params, cfg, cases, plan=None, rank=0, size=1):
    """The fp32 packed tick, then the padded chunk tick and the dual C == 1
    tick after it -> their logits (a TP plan: on this rank's heads)."""
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.models import model as M
    base = plan if plan is not None else ExecutionPlan.single_device()
    packed, pcache = cases["packed"]
    chunk, one, dcache = cases["padded"]
    with torch.no_grad():
        lp = M.paged_decode_step(params, cfg, packed,
                                 _heads_of(pcache, rank, size), base)[0]
        cache = _heads_of(dcache, rank, size)
        lc = M.paged_decode_step(params, cfg, chunk, cache, base)[0]
        ld = M.paged_decode_step(params, cfg, one, cache,
                                 base.with_dual_branch())[0]
    return {"packed": lp, "chunk": lc, "dual": ld}


def tp_serve_quant(params, cfg, cases, dev, plan=None, size=1):
    """One packed tick of the fp32 model on empty int8 pages -> its K / V
    pools and row scales, gathered over the group's heads under TP."""
    from repro_torch.core import tp
    from repro_torch.models import model as M
    packed = cases["packed"][0]
    cache = M.init_paged_cache(cfg, 512, PAGE, packed["seg_last"].numel(),
                               "float32", kv_dtype="int8", device=dev,
                               tp_size=size)
    with torch.no_grad():
        M.paged_decode_step(params, cfg, packed, cache, plan)
    if plan is None:
        return cache
    torch.cuda.synchronize(dev)
    out = {}
    for part in ("block0", "blocks"):
        out[part] = {}
        for k, v in cache[part].items():
            if k in ("k", "v"):
                rows = tp.gather_rows(v.contiguous(), plan.group,
                                      "checkpoint")
                v = torch.cat(list(rows), dim=-2)
            out[part][k] = v
    return out


def tp_serve_scatter(dev, plan=None):
    """Rows of K / V (mixed_tick's 272 rows, all 8 heads, D = 128) drawn on
    the card, quantized into int8 pages through ``attention._scatter_kv``
    (this rank's heads under TP: one MAX all-reduce of the rows' amax) ->
    the pools and scales (gathered over heads under TP)."""
    from repro_torch.core import tp
    from repro_torch.models import attention as A
    g = torch.Generator(device=dev).manual_seed(47)
    T = 272
    k = torch.randn((T, HKV, D), generator=g, device=dev)
    v = torch.randn((T, HKV, D), generator=g, device=dev)
    k[:, -1] *= 3                     # the last rank's head holds the amax
    size = 1 if plan is None else plan.tp_size
    hk = HKV // size
    r = 0 if plan is None else plan.tp_rank
    cache = {n: torch.zeros((T // PAGE + 1, PAGE, hk, D), dtype=torch.int8,
                            device=dev) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        cache[n] = torch.ones((T // PAGE + 1, PAGE), device=dev)
    tables = (1 + torch.arange(T // PAGE, dtype=torch.int32,
                               device=dev))[None]
    slot = torch.zeros(T, dtype=torch.int32, device=dev)
    rows = torch.arange(T, dtype=torch.int32, device=dev)
    A._scatter_kv(cache, k[:, r * hk:(r + 1) * hk].contiguous(),
                  v[:, r * hk:(r + 1) * hk].contiguous(),
                  lambda pool, vals: A.packed_scatter(pool, vals, tables,
                                                      slot, rows, PAGE),
                  None if plan is None else plan.inner())
    if plan is not None:
        for n in ("k", "v"):
            cache[n] = torch.cat(list(tp.gather_rows(cache[n], plan.group,
                                                     "checkpoint")), -2)
    return cache


def _int8_diff(got, want):
    """(codes compared, codes that differ, their largest step, largest
    relative scale difference, block 0 byte-exact) of two int8 caches,
    past the scratch page 0 (every padding row of a tick is written there,
    in an order the card does not fix)."""
    numel, n, step, rel = 0, 0, 0, 0.0
    exact0 = True
    for part in ("block0", "blocks"):
        for k in ("k", "v", "k_scale", "v_scale"):
            a, b = got[part][k], want[part][k]
            a, b = (a[1:], b[1:]) if part == "block0" else (a[:, 1:],
                                                             b[:, 1:])
            if k in ("k", "v"):
                d = (a.int() - b.int()).abs()
                numel += d.numel()
                n += int((d > 0).sum())
                step = max(step, int(d.max()))
                same = not bool((d > 0).any())
            else:
                rel = max(rel, ((a - b).abs() / b.abs()).max().item())
                same = torch.equal(a, b)
            if part == "block0" and not same:
                exact0 = False
    return numel, n, step, rel, exact0


def tp_serve_refs(dev, rank):
    """The one-device side of the TP serving check on this rank's card:
    the fp32 ticks, the int8 tick's pools and the scatter; rank 0 also the
    fp32 and bf16 engines' streams."""
    cfg, params = tp_serve_params(dev, "float32")
    cases = tp_serve_cases(cfg, dev)
    ref = {"ticks": tp_serve_ticks(params, cfg, cases),
           "quant": tp_serve_quant(params, cfg, cases, dev),
           "scatter": tp_serve_scatter(dev)}
    if rank == 0:
        ref["engine_fp32"] = tp_serve_engine(cfg, params, dev)
        del params
        bcfg, bparams = tp_serve_params(dev, "bfloat16")
        ref["engine_bf16"] = tp_serve_engine(bcfg, bparams, dev)
    return cases, ref


def tp_serve_gap(cfg, params, prompt, stream, j):
    """One device's top-2 logit gap where token j of ``stream`` was
    chosen (a full-sequence forward over the prompt and stream[:j])."""
    from repro_torch.models import model as M
    toks = list(prompt) + list(stream[:j])
    t = torch.tensor([toks], dtype=torch.int32, device=params["embed"][
        "emb"].device)
    with torch.no_grad():
        top = M.forward(params, cfg, {"tokens": t})[0][0, -1].float().topk(2)
    return float(top.values[0] - top.values[1])


def tp_serve_parts(group, dev, cases, ref, part, out):
    """The TP side, each path one ``part`` (counters from 0, host-clock ms
    with the card synchronised): (i) the fp32 ticks, (ii) the fp32 engine,
    (iii) the bf16 engine, (iv) the int8 tick and the scatter."""
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.launch import mesh as MX
    rank, size = group.rank(), group.size()
    plan = ExecutionPlan.from_group(group, tp="explicit")
    cfg, full = tp_serve_params(dev, "float32")
    shard = MX.shard_params(full, cfg, rank, size)
    del full
    torch.cuda.empty_cache()

    def ticks():
        got = tp_serve_ticks(shard, cfg, cases, plan, rank, size)
        res = {}
        live = {"packed": (cases["packed"][0]["tok_pos"] >= 0)[None],
                "chunk": (torch.arange(TP_SERVE_C, device=dev)[None]
                          < cases["padded"][0]["n_valid"][:, None]),
                "dual": (cases["padded"][1]["n_valid"] > 0)[:, None]}
        for k, v in got.items():
            want = ref["ticks"][k]
            res[k] = {"err": max_err(v[live[k]], want[live[k]]),
                      "top": want[live[k]].abs().max().item(),
                      "sum": v[live[k]].double().sum().item()}
        return res
    part("serve_ticks", ticks)

    def engine():
        streams, st, calls = tp_serve_engine(cfg, shard, dev, plan)
        return {"streams": streams, "stats": st, "calls": calls}
    part("serve_engine_fp32", engine)

    def quant():
        got = tp_serve_quant(shard, cfg, cases, dev, plan, size)
        numel, n, step, rel, exact0 = _int8_diff(got, ref["quant"])
        sc = tp_serve_scatter(dev, plan)
        exact = all(torch.equal(sc[k], ref["scatter"][k]) for k in sc)
        return {"codes_differ": n, "codes_numel": numel, "max_step": step,
                "scale_rel": rel, "block0_exact": exact0,
                "scatter_exact": exact}
    part("serve_int8", quant)
    del shard
    torch.cuda.empty_cache()

    bcfg, bfull = tp_serve_params(dev, "bfloat16")
    bshard = MX.shard_params(bfull, bcfg, rank, size)

    def bf16_engine():
        streams, st, calls = tp_serve_engine(bcfg, bshard, dev, plan)
        return {"streams": streams, "stats": st, "calls": calls}
    part("serve_engine_bf16", bf16_engine)
    del bshard
    if rank == 0:
        # where a bf16 stream leaves one device's, one device's top-2 gap
        prompts = dict(r for reqs in tp_serve_workload(bcfg.vocab)
                       for r in reqs)
        one = ref["engine_bf16"][0]
        gaps = {}
        for rid, st in out["serve_engine_bf16"]["streams"].items():
            j = common_prefix(st, one[rid])
            if j < len(one[rid]):
                gaps[rid] = (j, tp_serve_gap(bcfg, bfull, prompts[rid],
                                             one[rid], j))
        out["serve_bf16_gaps"] = gaps
        out["serve_ref_streams"] = {"fp32": ref["engine_fp32"],
                                    "bf16": ref["engine_bf16"]}
    del bfull
    torch.cuda.empty_cache()


def tp_serve_report(ranks):
    """Print and gate the TP serving parts; returns rank 0's launches over
    them."""
    L = TP_LAYERS
    r0 = ranks[0]
    one32, st32, calls32 = r0["serve_ref_streams"]["fp32"]
    one16 = r0["serve_ref_streams"]["bf16"][0]
    sums = {}
    for r in ranks:
        t = r["serve_ticks"]
        for k in ("packed", "chunk", "dual"):
            tol = TP_SERVE_FP32_TOL * max(1.0, t[k]["top"])
            print(f"  rank {r['rank']}: TP serving, fp32 {k} tick (llama3.2"
                  f"-3b full width, {L} layers, Hkv {HKV // TP_SIZE} a rank)"
                  f" vs one device: max |diff| {t[k]['err']:.3e} (max "
                  f"|logit| {t[k]['top']:.3f}; tol {tol:.3g})", flush=True)
            require(t[k]["err"] <= tol, f"TP serving {k} tick disagrees "
                    f"with one device")
            sums.setdefault(k, set()).add(t[k]["sum"])
        ar = _ar(t["counts"])
        print(f"  rank {r['rank']}: the three ticks paid {ar} all-reduces "
              f"(want 3 x (L + 1) = {3 * (L + 1)}); {t['ms']:.1f} ms over "
              f"gloo, host-memory staging included", flush=True)
        require(ar == 3 * (L + 1), "TP serving ticks: all-reduce count")
    require(all(len(v) == 1 for v in sums.values()),
            "TP serving ticks: logits differ across ranks")
    for label, key, one in (("fp32", "serve_engine_fp32", one32),
                            ("bf16", "serve_engine_bf16", one16)):
        for r in ranks:
            e = r[key]
            st = e["stats"]
            agree = sum(e["streams"][rid] == one[rid] for rid in one)
            print(f"  rank {r['rank']}: TP PagedEngine {label}, "
                  f"{len(one)} greedy requests x {TP_SERVE_NEW} new: "
                  f"{agree} / {len(one)} streams equal one device's; "
                  f"{st['ticks']} ticks, {st['calls']} packed calls, "
                  f"{st['cow']} copy-on-write, prefix hit rate "
                  f"{st['hit_rate']:.3f}; {e['ms']:.1f} ms = "
                  f"{e['ms'] / st['ticks']:.2f} ms a tick over gloo "
                  f"(host-memory staging, both ranks on one card; not a "
                  f"collective time); per-call (sum, max) all-reduces "
                  f"{sorted(set(e['calls']))}", flush=True)
            require(e["streams"] == ranks[0][key]["streams"],
                    f"TP {label} engine streams differ across ranks")
            require(st["cow"] > 0, "TP engine workload made no COW")
            require(set(e["calls"]) == {(L + 1, 0)},
                    f"TP {label} engine ticks: collectives {e['calls']}")
            if label == "fp32":
                require(e["streams"] == one, "TP fp32 engine streams differ "
                        "from one device's")
        if label == "bf16":
            for rid, (j, gap) in r0["serve_bf16_gaps"].items():
                print(f"  bf16 request {rid}: first divergence at token {j}"
                      f", one device's top-2 gap there {gap:.4f} (must be "
                      f"<= TP_LOGIT_TOL {TP_LOGIT_TOL})", flush=True)
                require(gap <= TP_LOGIT_TOL, "TP bf16 stream diverges at a "
                        "clear margin")
    for r in ranks:
        q = r["serve_int8"]
        print(f"  rank {r['rank']}: int8-page tick, pools gathered over "
              f"heads vs one device: {q['codes_differ']} of "
              f"{q['codes_numel']} codes differ (largest step "
              f"{q['max_step']}), scales max relative diff "
              f"{q['scale_rel']:.2e}, block 0 byte-exact "
              f"{q['block0_exact']}; the scatter of the same K / V rows: "
              f"byte-exact {q['scatter_exact']}; MAX all-reduces "
              f"{_ar(q['counts'], kind='all-reduce-max')} (want L + 1 = "
              f"{L + 1}: the tick's L and the scatter's one)", flush=True)
        require(q["scatter_exact"], "TP int8 scatter is not the one-device "
                "bytes")
        require(q["max_step"] <= 1
                and q["codes_differ"] <= TP_SERVE_CODES_FRAC
                * q["codes_numel"] and q["scale_rel"] <= TP_SERVE_SCALE_RTOL,
                "TP int8 pools disagree with one device")
        require(_ar(q["counts"], kind="all-reduce-max") == L + 1,
                "TP int8 tick: MAX all-reduce count")
    total = {}
    for name in ("serve_ticks", "serve_engine_fp32", "serve_int8",
                 "serve_engine_bf16"):
        for k, v in r0["launches"][name].items():
            total[k] = total.get(k, 0) + v
    e = r0["serve_engine_fp32"]
    print(f"  rank 0 launches on the TP serving parts: {total}; by part "
          f"{ {n: r0['launches'][n] for n in ('serve_ticks', 'serve_engine_fp32', 'serve_int8', 'serve_engine_bf16')} }",
          flush=True)
    want = {"paged_packed_attention": L * e["stats"]["calls"],
            "page_copy": e["stats"]["cow"]}
    got = {k: r0["launches"]["serve_engine_fp32"].get(k, 0) for k in want}
    require(got == want, f"TP fp32 engine launches {got} != {want}")
    for k in ("paged_packed_attention", "paged_chunk_attention",
              "paged_decode_attention", "fused_dual_branch_decode",
              "page_copy", "fused_ln_add"):
        require(total.get(k, 0) > 0, f"{k} not launched on the TP serving "
                f"parts")
    return total


def tp_phase(smi):
    """Explicit TP at llama3.2-3b full width, 4 layers, over two ranks on
    this card (``core.tp.run_ranks`` over gloo, which stages CUDA tensors
    through host memory); NCCL too where there are two cards.  Returns
    ({kernel: launches in the TP paths of rank 0}, rank 0's median TP
    train step in ms, {kernel: rank 0's launches on the TP serving
    paths}, {arch: {part: rank 0's launches on the families' TP parts}}),
    all over gloo."""
    from repro_torch.core import tp
    n_cards = torch.cuda.device_count()
    backends = ["gloo"] + (["nccl"] if n_cards >= TP_SIZE else [])
    if n_cards < TP_SIZE:
        try:
            tp.init_tp_group("nccl", rank=0, world_size=TP_SIZE)
            raise AssertionError("init_tp_group('nccl') did not refuse")
        except RuntimeError as e:
            print(f"  nccl: not run ({n_cards} card(s)); init_tp_group "
                  f"refuses it: {e}", flush=True)
    torch.cuda.empty_cache()
    tp_launches, step_ms, serve_launches, fam = None, None, None, None
    for backend in backends:
        phase(f"tensor parallelism: backend {backend}, world size "
              f"{TP_SIZE}, llama3.2-3b full width, {TP_LAYERS} layers, "
              f"B=1, S={TP_SEQ}; card {smi}")
        t0 = time.perf_counter()
        ranks = tp.run_ranks("chip_smoke:tp_rank", TP_SIZE, backend=backend,
                             args=(backend,), timeout=900)
        print(f"  {TP_SIZE} ranks done in {time.perf_counter() - t0:.1f} s "
              f"on {[r['device'] for r in ranks]}", flush=True)
        launches = tp_report(ranks, backend, smi)
        serve = tp_serve_report(ranks)
        family = tp_family_report(ranks)
        if backend == "gloo":
            tp_launches, serve_launches, fam = launches, serve, family
            step_ms = statistics.median(ranks[0]["train"]["step_ms"])
    return tp_launches, step_ms, serve_launches, fam


def _ar(counts, direction="forward", what="calls", kind="all-reduce"):
    from repro_torch.core import tp
    return tp.count(counts, kind, direction, what)


def tp_report(ranks, backend, smi):
    """Print and gate the ranks' results; returns rank 0's launches summed
    over the TP paths."""
    r0 = ranks[0]
    L = TP_LAYERS
    for r in ranks:
        f = r["forward"]
        print(f"  rank {r['rank']}: bf16 forward logits vs one device on "
              f"the card: max |diff| {f['logit_err']:.4f} (max |logit| "
              f"{f['logit_top']:.3f}; tol {TP_LOGIT_TOL}); all-reduces "
              f"{_ar(f['counts'])} (want {L + 1}); "
              f"{f['ms']:.1f} ms", flush=True)
        require(f["logit_err"] <= TP_LOGIT_TOL, "TP logits disagree with "
                "the one-device forward")
        require(_ar(f["counts"]) == L + 1, "TP forward all-reduces")
    require(len({r["forward"]["logit_sum"] for r in ranks}) == 1,
            "TP logits differ across ranks")
    for r in ranks:
        f = r["mla"]
        tol = 1e-3 * max(1.0, f["logit_top"])
        print(f"  rank {r['rank']}: {MLA_ARCH} (MLA; full width, "
              f"{MLA_TP_LAYERS} layers + MTP, fp32, S={MLA_TP_SEQ}) forward "
              f"logits vs one device: max |diff| {f['logit_err']:.3e} (max "
              f"|logit| {f['logit_top']:.3f}; tol {tol:.3g}); all-reduces "
              f"{_ar(f['counts'])} (want {MLA_TP_LAYERS + 1}); {f['ms']:.1f}"
              f" ms", flush=True)
        require(f["logit_err"] <= tol, "MLA TP logits disagree with one "
                "device")
        require(_ar(f["counts"]) == MLA_TP_LAYERS + 1,
                "MLA TP forward all-reduces != L + 1")
    print(f"  one all-reduce of {r0['all_reduce_bytes']} B (1 x {TP_SEQ} x "
          f"d_model bf16) over {backend}: median "
          f"{[round(r['all_reduce_ms'], 2) for r in ranks]} ms by rank "
          f"(host clock, 5 calls after one; card {smi})", flush=True)
    one = r0["one_device_train"]
    for r in ranks:
        hist = r["train"]["hist"]
        print(f"  rank {r['rank']}: trainer.train {TP_STEPS} steps (fal, "
              f"fp32 masters, bf16 compute, remat): TP (loss, grad_norm) "
              f"{[(round(a, 5), round(b, 4)) for a, b in hist]}, one device "
              f"{[(round(a, 5), round(b, 4)) for a, b in one]} (tol "
              f"{TP_LOSS_TOL} / relative {TP_GNORM_RTOL}); step ms "
              f"{[round(t, 1) for t in r['train']['step_ms']]} over "
              f"{backend} through host memory, both ranks on one card (no "
              f"measure of the paper's claim; one device: "
              f"{[round(t, 1) for t in r0['one_device_step_ms']]}); card "
              f"{smi}", flush=True)
        for (la, ga), (lb, gb) in zip(hist, one):
            require(abs(la - lb) <= TP_LOSS_TOL
                    and abs(ga - gb) <= TP_GNORM_RTOL * gb,
                    "TP training disagrees with one device")
    counts = {}
    for mode in ("fal", "preln"):
        c = r0[mode]["train"]
        counts[mode] = c
        print(f"  {mode}: all-reduces forward {_ar(c)} ({_ar(c, what='bytes')}"
              f" B), backward {_ar(c, 'backward')} "
              f"({_ar(c, 'backward', 'bytes')} B), step "
              f"{_ar(c, 'step')} ({_ar(c, 'step', 'bytes')} B); "
              f"forward + backward {r0[mode]['ms']:.1f} ms over {backend} "
              f"through host memory", flush=True)
    fal, pre = counts["fal"], counts["preln"]
    for d in ("forward", "backward"):
        ratio = _ar(fal, d, "bytes") / _ar(pre, d, "bytes")
        print(f"  fal / preln all-reduce bytes, {d}: {ratio:.4f} "
              f"((L + 1) / (2 L) = {(L + 1) / (2 * L):.4f})", flush=True)
        require(_ar(fal, d, "bytes") * 2 * L == _ar(pre, d, "bytes")
                * (L + 1), f"fal / preln {d} bytes != (L + 1) / (2 L)")
    require((_ar(fal), _ar(pre)) == (L + 1, 2 * L)
            and (_ar(fal, "backward"), _ar(pre, "backward"))
            == (L + 1, 2 * L), "fal / preln all-reduce counts")
    for mode in ("fal", "preln"):
        repl, sp = r0[mode]["forward"], r0[f"{mode}_sp"]["forward"]
        ar_b, sp_ar_b = _ar(repl, what="bytes"), _ar(sp, what="bytes")
        sp_rs_b = _ar(sp, what="bytes", kind="reduce-scatter")
        sp_rs_n = _ar(sp, kind="reduce-scatter")
        print(f"  {mode} SP forward: {_ar(sp)} all-reduces ({sp_ar_b} B), "
              f"{sp_rs_n} reduce-scatters ({sp_rs_b} B), "
              f"{_ar(sp, kind='all-gather')} all-gathers; replicated "
              f"{_ar(repl)} all-reduces ({ar_b} B); SP loss "
              f"{r0[f'{mode}_sp']['loss']:.5f} vs {r0[mode]['loss']:.5f}",
              flush=True)
        require(_ar(sp) + sp_rs_n == _ar(repl)
                and sp_ar_b + TP_SIZE * sp_rs_b == ar_b,
                f"{mode} SP reduce counts / bytes")
    for r in ranks:
        t, d = r["tick"], r["dual_tick"]
        print(f"  rank {r['rank']}: decode tick of one block (bf16, Hkv "
              f"{tp_config().n_kv_heads // TP_SIZE} a rank, d_ff "
              f"{tp_config().d_ff // TP_SIZE}): vs one device sequential "
              f"{t['err']:.4f}, dual {d['err']:.4f} (tol {TP_TICK_ULPS} bf16 "
              f"ulps = {TP_TICK_ULPS * t['ulp']:.4f}); dual vs sequential "
              f"{r['dual_vs_sequential']:.4f}; all-reduces {_ar(t['counts'])}"
              f" / {_ar(d['counts'])}; {t['ms']:.2f} / {d['ms']:.2f} ms",
              flush=True)
        require(t["counts"] == d["counts"] and _ar(t["counts"]) == 1,
                "TP decode ticks: sequential and dual collectives differ")
        require(max(t["err"], d["err"]) <= TP_TICK_ULPS * t["ulp"],
                "TP decode tick disagrees with one device")
    total = {}
    for r in ranks:
        tot = {}
        for part, counts in r["launches"].items():
            for k, v in counts.items():
                tot[k] = tot.get(k, 0) + v
        print(f"  rank {r['rank']} launches on the TP paths: {tot}; by "
              f"part {r['launches']}; paths {r['paths']}", flush=True)
        for k in ("flash_attention", "flash_attention.bwd", "fused_ln_add",
                  "fused_ln_add.bwd", "paged_decode_attention",
                  "fused_dual_branch_decode"):
            require(tot.get(k, 0) > 0, f"rank {r['rank']}: {k} not launched "
                    f"on the TP paths")
        n = TP_STEPS
        want = {"flash_attention": 2 * n * L, "flash_attention.bwd": n * L}
        got = {k: r["launches"]["train"].get(k, 0) for k in want}
        require(got == want, f"TP train launches {got} != {want}")
        if r["rank"] == 0:
            total = tot
    return total


# --------------------------------------------------------------------------- #
# data parallelism, compressed backward collectives, checkpoints under TP
# --------------------------------------------------------------------------- #
#: tp 2 x dp 2: four gloo ranks on this card, llama3.2-3b's widths at
#: DP_LAYERS layers with a DP_VOCAB-token vocabulary, a global batch of 2
#: (one row a data rank) of DP_SEQ tokens.  fp32 compute (``dp_config``).
#: gloo stages every collective through host memory and measures no NCCL
#: time, so the phase checks counts, bytes, gradients and the checkpoint,
#: and its size buys nothing: 2 layers and a 32768-token vocabulary (the
#: tied embedding was two thirds of the 4-layer model) cut the all-reduced
#: gradient and the checkpoint to about a third, 16384 tokens (since the
#: ssm / hybrid / audio families' TP part joined phase 13a) by a quarter
#: more; 2 steps a method
DP_TP, DP_SIZE, DP_STEPS, DP_BATCH, DP_SEQ = 2, 2, 2, 2, 1024
DP_LAYERS, DP_VOCAB = 2, 16384
DP_METHODS = ("none", "int8", "lowrank")
#: int8's backward wire bytes against "none"'s, at most
#: (benchmarks/bench_comm.py's gate on the reference)
DP_INT8_WIRE = 0.3
#: the FSDP run's params after DP_STEPS against "none"'s, gathered: at most
#: DP_PARAM_ATOL + DP_PARAM_RTOL x the leaf's largest value (the CPU
#: tests' gate, tests/test_torch_fsdp.py)
DP_PARAM_ATOL, DP_PARAM_RTOL = 1e-6, 1e-4


def dp_config():
    """The TP phase's model (fal, remat) in fp32 compute: the reference's
    bench_comm measures int8 against an fp32 all-reduce, so the 0.3 gate
    holds for fp32 cotangents (one byte for four; for bf16 ones it would
    be one for two)."""
    return tp_config(remat=True, dtype="float32").replace(
        n_layers=DP_LAYERS, vocab=DP_VOCAB)


def _flat_grads(params):
    """Every leaf's gradient, flat, in host memory (four ranks share the
    card)."""
    from repro_torch.optim import adamw
    return torch.cat([p.grad.reshape(-1).cpu()
                      for _, p in adamw.named_leaves(params)])


def _timed(dev, fn):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    return res, (time.perf_counter() - t0) * 1e3


def dp_rank(groups, ckpt_dir):
    """One rank of the DP phase (spawned by ``core.tp.run_ranks`` with
    ``tp_size``): rank 0 first trains DP_STEPS steps on one device (the
    global batch of 2); then, with the launch counters zeroed, every rank
    trains DP_STEPS steps of each ``grad_compress`` method from the same weights (its
    rows of the same global batches; each method's first gradients, read
    through ``on_grads``, against "none"'s; right after "none" its state is
    saved (``checkpoint.save_distributed``) and rank 0 restores it into
    one device on the card); times DP all-reduces of its gradient size.
    Returns numbers only."""
    import torch.distributed as dist
    from repro_torch.core import tp
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.data.pipeline import SyntheticMarkov, shard_rows
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as MX
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    dev = tp_device(rank)
    cfg = dp_config()
    ocfg = adamw.AdamWConfig(lr=3e-4)
    plan = ExecutionPlan.from_group(groups.tp, tp="explicit",
                                    data_group=groups.dp)
    out = {"rank": rank, "tp_rank": plan.tp_rank, "dp_rank": plan.dp_rank,
           "device": str(dev)}
    data = SyntheticMarkov(cfg.vocab, DP_SEQ, DP_BATCH, seed=0)
    glob = [{"tokens": torch.from_numpy(data.batch_at(i)["tokens"]).to(dev)}
            for i in range(DP_STEPS)]
    mine = [shard_rows(b, plan.dp_rank, plan.dp_size) for b in glob]
    full = M.init_params(cfg, seed=0, device=dev, dtype=cfg.param_dtype)
    if rank == 0:                 # the one-device run of the global batch
        state = tstep.init_state(0, cfg, ocfg, params=adamw.map_tree(
            lambda t: t.detach().clone(), full))
        step = tstep.make_train_step(cfg, ocfg)
        hist, ms = [], []
        for b in glob:
            (state, m), t = _timed(dev, lambda: step(state, b))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            ms.append(t)
        out["one_device"] = {"hist": hist, "step_ms": ms}
        del state, step
    # this rank's shard waits in host memory: four ranks' states at ~16 B
    # a parameter fill most of the card
    shard = adamw.map_tree(lambda t: t.cpu(), MX.shard_params(
        full, cfg, plan.tp_rank, plan.tp_size))
    del full
    torch.cuda.empty_cache()
    dist.barrier()              # the DP paths start together on every rank

    ops.reset_launches()
    ops.reset_dispatch_paths()
    torch.cuda.reset_peak_memory_stats(dev)
    first = None
    for method in DP_METHODS:
        pm = plan.with_grad_compress(method)
        state = tstep.init_state(0, cfg, ocfg, params=adamw.map_tree(
            lambda t: t.to(dev, copy=True), shard))
        res = {"hist": [], "step_ms": [], "counts": []}
        grads = []

        def keep_first(params):
            if not grads:
                grads.append(_flat_grads(params))
        step = tstep.make_train_step(cfg, ocfg, pm, on_grads=keep_first)
        for b in mine:
            tp.reset_collectives()
            (state, m), t = _timed(dev, lambda: step(state, b))
            res["counts"].append(tp.collective_counts())
            res["hist"].append((float(m["loss"]), float(m["grad_norm"])))
            res["step_ms"].append(t)
        if first is None:
            first = grads[0]
        else:
            res["grad_err"] = ((grads[0] - first).norm()
                               / first.norm()).item()
        out[method] = res
        if method == "none":     # checkpointed before the next state exists
            out["n_local"] = sum(p.numel() for _, p in
                                 adamw.named_leaves(state["params"]))
            none_params = adamw.map_tree(lambda t: t.detach().cpu(),
                                         state["params"])
            peak = torch.cuda.max_memory_allocated(dev)
            out.update(_dp_checkpoint(state, cfg, plan, ocfg, ckpt_dir,
                                      dev))
            torch.cuda.reset_peak_memory_stats(dev)
        del state, step
        torch.cuda.empty_cache()
    del first
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["paths"] = ops.dispatch_paths()
    out["peak"] = max(peak, torch.cuda.max_memory_allocated(dev))
    out["fsdp"] = _dp_fsdp(groups, cfg, ocfg, shard, mine, none_params, dev)
    del none_params, shard
    torch.cuda.empty_cache()
    out["seq"] = _dp_seq_decode(groups, dev)
    flat = torch.zeros(out["n_local"], device=dev)
    out["dp_all_reduce_ms"] = [_timed(dev, lambda: tp.all_reduce_(
        [flat], groups.dp, "data"))[1] for _ in range(2)]
    del flat
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _dp_fsdp(groups, cfg, ocfg, shard, mine, none_params, dev):
    """The FSDP run of ``dp_rank``: this rank's TP ``shard`` (host memory)
    cut to its data rank's FSDP slices, moved to the card, the peak
    counter reset with only that state there, then DP_STEPS steps of its
    rows ``mine`` under the FSDP plan.  -> numbers: history, step times,
    counts, launches and paths, the state's bytes, the peak, the largest
    param error against ``none_params`` (the "none" run's shard, host
    memory) as a fraction of its gate, the data group's FSDP layout."""
    import torch.distributed as dist
    from repro_torch.core import tp
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as MX
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    plan = ExecutionPlan.from_group(groups.tp, tp="explicit",
                                    data_group=groups.dp, fsdp=True)
    slices = MX.shard_fsdp(shard, cfg, plan.dp_rank, plan.dp_size,
                           plan.tp_size)
    state = tstep.init_state(0, cfg, ocfg, params=adamw.map_tree(
        lambda t: t.to(dev, copy=True), slices))
    del slices
    out = {"state_bytes": sum(
        t.numel() * t.element_size() for _, t in adamw.named_leaves(
            {"params": state["params"], "m": state["opt"]["m"],
             "v": state["opt"]["v"]})),
           "n_sliced": len(MX.fsdp_layout(cfg, plan.tp_size, plan.dp_size)),
           "hist": [], "step_ms": [], "counts": []}
    torch.cuda.empty_cache()
    dist.barrier()
    ops.reset_launches()
    ops.reset_dispatch_paths()
    torch.cuda.reset_peak_memory_stats(dev)
    step = tstep.make_train_step(cfg, ocfg, plan)
    for b in mine:
        tp.reset_collectives()
        (state, m), t = _timed(dev, lambda: step(state, b))
        out["counts"].append(tp.collective_counts())
        out["hist"].append((float(m["loss"]), float(m["grad_norm"])))
        out["step_ms"].append(t)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["paths"] = ops.dispatch_paths()
    got = dict(adamw.named_leaves(MX.gather_fsdp_over_group(
        state["params"], cfg, groups.dp, plan.tp_size)))
    err = 0.0
    for path, want in adamw.named_leaves(none_params):
        tol = DP_PARAM_ATOL + DP_PARAM_RTOL * float(want.abs().max())
        err = max(err, float((got[path].cpu() - want).abs().max()) / tol)
    out["param_err"] = err
    del state, step, got
    torch.cuda.empty_cache()
    dist.barrier()
    return out


#: the sequence-cut decode check of ``dp_rank`` (the reference's decode
#: cache layout, launch/mesh.py ``cache_specs``): case -> (config
#: overrides of the arch, batch, cache positions, tick positions of lane 0
#: (lane b three behind), weights' and cache's dtype).  llama3.2-3b: one
#: row, the sequence over data 2 and the KV heads over model 2; the first
#: tick in data rank 0's half (every data rank 1 fully masked), the last
#: two past the end (their rows clamp to S - 1).  deepseek-v3-671b's three
#: dense layers (no MoE, no MTP): its latent over model 2 at batch 2 (rows
#: over data 2) and over data x model at batch 1.  Bytes a rank: llama
#: full params 3.2 GB + the whole fp32 cache 1.07 GB while its slice
#: (0.27 GB) and TP shard (2.4 GB, the embedding shared) are cut, ~5.4 GB
#: at the peak; deepseek full params 7.2 GB bf16 + its shard's 1.75 GB of
#: copies, ~9 GB; four ranks ~36 GB of the card at once
SEQ_CASES = {
    "llama3.2-3b": ("llama3.2-3b", dict(n_layers=4, dtype="float32"), 1,
                    32768,
                    (1000,) + tuple(range(32755, 32770)), "float32"),
    "deepseek-v3 rows": ("deepseek-v3-671b", dict(n_layers=3, mtp_depth=0),
                         2, 8192, (100,) + tuple(range(8187, 8194)),
                         "bfloat16"),
    "deepseek-v3 batch 1": ("deepseek-v3-671b",
                            dict(n_layers=3, mtp_depth=0), 1, 8192,
                            (100,) + tuple(range(8187, 8194)), "bfloat16")}


def seq_case_config(name):
    from repro_torch.configs.base import get_config
    arch, over, *_ = SEQ_CASES[name]
    return get_config(arch).replace(**over)


def _greedy_ticks(step, params, cache, tok, ticks):
    """Greedy ticks of ``step`` from ``tok`` at the positions ``ticks`` (T,
    B) -> (logits (T, B, V) fp32 in host memory, tokens (T, B))."""
    logits, toks = [], []
    for pos in ticks:
        tok, lg, cache = step(params, cache, tok[:, None], pos)
        logits.append(lg[:, 0].float().cpu())
        toks.append(tok.cpu())
    return torch.stack(logits), torch.stack(toks)


def _dp_seq_decode(groups, dev):
    """The sequence-cut decode of ``dp_rank`` (SEQ_CASES): each rank builds
    the whole weights and a seeded history, rank 0 decodes it on one
    device (the reference), then every rank cuts its TP shard and its
    slice of the cache (``launch.mesh.slice_cache``) and, with the launch
    and collective counters zeroed, runs the same greedy ticks under the
    plan of the reference's layout.  -> numbers by case."""
    import torch.distributed as dist
    from repro_torch.core import tp
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as MX
    from repro_torch.models import model as M
    from repro_torch.serve.decode import make_serve_step
    rank = dist.get_rank()
    ts, tr = groups.tp.size(), groups.tp.rank()
    ds, dr = groups.dp.size(), groups.dp.rank()
    out, t0 = {}, time.perf_counter()
    for name, (_, _, B, S, pos0, dtype) in SEQ_CASES.items():
        cfg = seq_case_config(name)
        full = M.init_params(cfg, seed=5, device=dev, dtype=dtype)
        one = M.init_cache(cfg, B, S, dtype, device=dev)
        g = torch.Generator(device=dev).manual_seed(6)
        for part in one.values():
            for leaf in part.values():
                leaf.copy_(torch.randn(leaf.shape, generator=g, device=dev))
        mine = MX.slice_cache(one, cfg, ts, ds, B, tr, dr)
        ticks = (torch.tensor(pos0, dtype=torch.int32)[:, None]
                 - 3 * torch.arange(B, dtype=torch.int32)[None]).to(dev)
        tok0 = torch.randint(0, cfg.vocab, (B,), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(7))
        res = {}
        if rank == 0:
            with torch.no_grad():
                res["ref"] = _greedy_ticks(make_serve_step(cfg), full, one,
                                           tok0.to(dev), ticks)
        del one
        shard = MX.shard_params(full, cfg, tr, ts)
        del full
        torch.cuda.empty_cache()
        axes = MX.seq_axes(cfg, ts, ds, B)
        plan = ExecutionPlan.from_group(
            groups.tp, tp="explicit",
            data_group=groups.dp if "data" in axes else None
        ).with_cache_layout(cfg, B)
        part = MX.rank_slice(cfg, ts, ds, B, S, tr, dr)
        lo, hi = part["rows"]
        step = make_serve_step(cfg, plan)
        dist.barrier()        # every rank's shard and slice are cut
        ops.reset_launches()
        ops.reset_dispatch_paths()
        counts, logits, toks = [], [], []
        tok = tok0[lo:hi].to(dev)
        with torch.no_grad():
            for pos in ticks:
                tp.reset_collectives()
                tok, lg, mine = step(shard, mine, tok[:, None], pos[lo:hi])
                counts.append({k: v["seq"]["calls"] for k, v in
                               tp.collective_counts().items() if "seq" in v})
                logits.append(lg[:, 0].float().cpu())
                toks.append(tok.cpu())
        torch.cuda.synchronize(dev)
        res.update(logits=torch.stack(logits), tokens=torch.stack(toks),
                   counts=counts, rows=part["rows"],
                   positions=part["positions"], seq_axes=plan.seq_axes,
                   cache_bytes=sum(t.numel() * t.element_size()
                                   for p in mine.values()
                                   for t in p.values()),
                   launches={k: v for k, v in ops.launch_counts().items()
                             if v},
                   paths=ops.dispatch_paths())
        out[name] = res
        del shard, mine
        torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"] = time.perf_counter() - t0
    return out


def dp_seq_report(ranks, smi):
    """Print and gate the sequence-cut decode of the DP ranks against rank
    0's one device, the dry run's cache bytes at tp 2 x dp 2
    (``specs.decode_input_specs`` on ``meta``) and the combine's counts.
    Returns rank 0's fused_ln_add launches over the cases."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    launches = 0
    for name, (_, _, B, S, pos0, dtype) in SEQ_CASES.items():
        cfg = seq_case_config(name)
        ref_logits, ref_tokens = ranks[0]["seq"][name]["ref"]
        want_bytes = DR.storage_bytes(SP.decode_input_specs(
            cfg, ShapeConfig("seq_cut", S, B, "decode"), DP_TP, DP_SIZE,
            cache_dtype=dtype)[1])
        n = cfg.n_layers
        by_rows = {}
        for r in ranks:
            g = r["seq"][name]
            lo, hi = g["rows"]
            want, toks = ref_logits[:, lo:hi], ref_tokens[:, lo:hi]
            same = (g["tokens"] == toks).all(dim=1)
            first = int((~same).nonzero()[0, 0]) if not same.all() \
                else len(pos0)
            upto = min(first + 1, len(pos0))
            err = (g["logits"][:upto] - want[:upto]).abs().max().item()
            top = want.abs().max().item()
            tol = (TP_SERVE_FP32_TOL * max(1.0, top) if dtype == "float32"
                   else TP_LOGIT_TOL)
            axes = g["seq_axes"]
            want_counts = {"all-reduce-max": n * len(axes),
                           "all-reduce": n * len(axes)}
            if "model" in axes:
                want_counts["all-gather"] = n
            held = ("throughout" if first == len(pos0)
                    else f"to tick {first}")
            print(f"  sequence-cut decode, {name} (rank {r['rank']}: tp "
                  f"{r['tp_rank']}, dp {r['dp_rank']}; rows {g['rows']}, "
                  f"positions {g['positions']} of {S}, cut over {axes}): "
                  f"{len(pos0)} greedy ticks, tokens equal to one device "
                  f"{held}; max |logit diff| {err:.4g} through tick "
                  f"{upto - 1} (|logit| {top:.3f}, tol {tol:.3g}); cache "
                  f"{g['cache_bytes']} B (dry run {want_bytes} B); seq "
                  f"collectives a tick {g['counts'][0]}; launches "
                  f"{g['launches']}; card {smi}", flush=True)
            require(first == len(pos0) or dtype != "float32",
                    f"{name}: fp32 tokens differ from one device at tick "
                    f"{first}")
            require(err <= tol, f"{name}: logits {err:.4g} from one device")
            require(g["cache_bytes"] == want_bytes,
                    f"{name}: cache {g['cache_bytes']} B != the dry run's "
                    f"{want_bytes} B")
            require(all(c == want_counts for c in g["counts"]),
                    f"{name}: seq collectives {g['counts']} != "
                    f"{want_counts} a tick")
            require(g["launches"] == {"fused_ln_add": len(pos0) * n}
                    and g["paths"] == {"fused_ln_add": ops.CUDA},
                    f"{name}: launches {g['launches']} paths {g['paths']}")
            by_rows.setdefault((lo, hi), []).append(g["logits"])
        for same_rows in by_rows.values():
            require(all(torch.equal(x, same_rows[0]) for x in same_rows),
                    f"{name}: ranks serving the same rows differ")
        launches += ranks[0]["seq"][name]["launches"].get("fused_ln_add", 0)
    print(f"  sequence-cut decode: {ranks[0]['seq']['seconds']:.1f} s of "
          f"the spawn (weights, histories, the one-device references and "
          f"the ticks of {len(SEQ_CASES)} cases); card {smi}", flush=True)
    return launches


def _dp_checkpoint(state, cfg, plan, ocfg, ckpt_dir, dev):
    """Save ``state`` under the tp x dp plan (``save_distributed``), free
    every rank's card memory but the state's, and on rank 0 restore the
    file into one device on the card and compare it bit for bit with the
    gathered state.  -> numbers for the report."""
    import torch.distributed as dist
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as CK
    out = {}
    gathered, t = _timed(dev, lambda: CK.save_distributed(
        ckpt_dir, state, cfg, plan, step=DP_STEPS,
        meta={"arch": cfg.arch_id}))
    out["save_s"] = t / 1e3
    if dist.get_rank() == 0:
        gathered = adamw.map_tree(lambda t: t.detach().cpu()
                                  if isinstance(t, torch.Tensor) else t,
                                  gathered)
        like = {"params": M.init_params(cfg, seed=1, device=dev,
                                        dtype=cfg.param_dtype)}
        like["opt"] = adamw.init_opt_state(like["params"], ocfg)
        restored, t = _timed(dev, lambda: CK.restore(ckpt_dir, like))
        out["restore_s"] = t / 1e3
        got = dict(adamw.named_leaves(restored))
        want = dict(adamw.named_leaves(gathered))
        out["ckpt_leaves"] = len(want)
        out["ckpt_equal"] = got.keys() == want.keys() and all(
            torch.equal(got[k].cpu(), want[k])
            if isinstance(want[k], torch.Tensor) else got[k] == want[k]
            for k in want)
        out["ckpt_bytes"] = sum(f.stat().st_size for f in
                                pathlib.Path(ckpt_dir).iterdir())
        out["ckpt_on_card"] = all(t.is_cuda for t in got.values()
                                  if isinstance(t, torch.Tensor))
        del like, restored, got
    del gathered
    torch.cuda.empty_cache()
    dist.barrier()              # the next method starts on every rank
    return out


def dp_phase(smi):
    """tp 2 x dp 2 at llama3.2-3b's widths (``dp_config``: DP_LAYERS
    layers, a DP_VOCAB vocabulary) over four gloo ranks on this card (``core.tp.run_ranks(..., tp_size=2)``; CUDA
    tensors staged through host memory).  Returns ({kernel: launches on
    the DP paths of rank 0}, a summary for the last lines)."""
    import tempfile
    from repro_torch.core import tp
    world = DP_TP * DP_SIZE
    n_cards = torch.cuda.device_count()
    if n_cards < world:
        try:
            tp.init_tp_group("nccl", rank=0, world_size=world)
            raise AssertionError("init_tp_group('nccl') did not refuse")
        except RuntimeError as e:
            print(f"  nccl: not run ({n_cards} card(s) for {world} ranks); "
                  f"init_tp_group refuses it: {e}", flush=True)
    phase(f"data parallelism: tp {DP_TP} x dp {DP_SIZE} = {world} gloo "
          f"ranks on this card, llama3.2-3b widths, {DP_LAYERS} layers, "
          f"vocab {DP_VOCAB}, fp32 compute, remat, global batch {DP_BATCH} x "
          f"{DP_SEQ}; grad_compress {'/'.join(DP_METHODS)}; card {smi}")
    gc.collect()                # this process's tensors off the card
    torch.cuda.empty_cache()
    # the ranks' allocators give back what they free (four share the card)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory(prefix="dp_ckpt_") as ckpt:
            t0 = time.perf_counter()
            ranks = tp.run_ranks("chip_smoke:dp_rank", world,
                                 backend="gloo", args=(ckpt,), timeout=600,
                                 tp_size=DP_TP)
            secs = time.perf_counter() - t0
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    print(f"  {world} ranks done in {secs:.1f} s on "
          f"{[r['device'] for r in ranks]}", flush=True)
    launches, summary = dp_report(ranks, smi)
    fsdp_launches, summary["fsdp"] = dp_fsdp_report(ranks, smi)
    summary["seq_launches"] = dp_seq_report(ranks, smi)
    return launches, fsdp_launches, summary


def dp_fsdp_report(ranks, smi):
    """Print and gate the FSDP run of the DP ranks against one device, the
    "none" run and ``launch/dryrun.py``'s ``lower_pair`` at Mesh(1,
    DP_SIZE, DP_TP) with the phase's overrides (run here, on ``meta``).
    Returns (rank 0's launches, a summary)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tp
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR
    L, gib = DP_LAYERS, 2 ** 30
    info = DR.lower_pair(
        "llama3.2-3b", ShapeConfig("dp_phase", DP_SEQ, DP_BATCH, "train"),
        DR.Mesh(1, DP_SIZE, DP_TP), microbatches=1,
        extra_overrides=dict(n_layers=DP_LAYERS, vocab=DP_VOCAB,
                             dtype="float32", remat=True))
    mem = info["memory"]
    tokens = info["rows"] * DP_SEQ * 4
    one = ranks[0]["one_device"]["hist"]
    print(f"  FSDP dry run (meta, Mesh(1, {DP_SIZE}, {DP_TP})): arguments "
          f"{mem['argument_bytes']} B ({tokens} B of tokens), peak "
          f"{mem['peak_bytes']} B ({mem['peak_bytes'] / gib:.3f} GiB), "
          f"traced in {info['trace_s']} s", flush=True)
    for r in ranks:
        f = r["fsdp"]
        err = (mem["peak_bytes"] - f["peak"]) / f["peak"]
        print(f"  rank {r['rank']}: fsdp (loss, grad_norm) "
              f"{[(round(a, 5), round(b, 4)) for a, b in f['hist']]}; step "
              f"ms {[round(t, 1) for t in f['step_ms']]} (gloo through host "
              f"memory); params vs none {f['param_err']:.3f} of the gate; "
              f"state {f['state_bytes']} B ({f['n_sliced']} leaves sliced) "
              f"vs none's {4 * 3 * r['n_local']} B; peak "
              f"{f['peak'] / gib:.3f} GiB measured vs "
              f"{mem['peak_bytes'] / gib:.3f} GiB predicted ({err:+.4f}); "
              f"launches {f['launches']}; "
              f"card {smi}", flush=True)
        for (la, ga), (lb, gb) in zip(f["hist"], one):
            require(abs(la - lb) <= TP_LOSS_TOL
                    and abs(ga - gb) <= TP_GNORM_RTOL * gb,
                    "FSDP training disagrees with one device")
        require(f["param_err"] <= 1.0, f"FSDP params vs none: "
                f"{f['param_err']:.3f} of the gate")
        for c in f["counts"]:
            require(tp.count(c, "all-gather", "fsdp") == 2 * L
                    and tp.count(c, "reduce-scatter", "fsdp") == L
                    and _ar(c, "data") == 1 and _ar(c, "metric") == 1,
                    f"FSDP collectives a step {c}")
        require(f["state_bytes"] == mem["argument_bytes"] - tokens,
                f"FSDP state {f['state_bytes']} B != the dry run's "
                f"arguments less the tokens {mem['argument_bytes'] - tokens}")
        require(abs(err) <= DRYRUN_PEAK_RTOL,
                f"FSDP peak: predicted {mem['peak_bytes']} vs measured "
                f"{f['peak']}: {err:+.4f}")
        require(set(f["paths"].values()) == {ops.CUDA}
                and {"flash_attention", "fused_ln_add"} <= set(f["paths"]),
                f"rank {r['rank']}: FSDP paths {f['paths']}")
        want = {"flash_attention": 2 * DP_STEPS * L,
                "flash_attention.bwd": DP_STEPS * L}
        got = {k: f["launches"].get(k, 0) for k in want}
        require(got == want, f"FSDP launches {got} != {want}")
        for k in ("fused_ln_add", "fused_ln_add.bwd"):
            require(f["launches"].get(k, 0) > 0, f"rank {r['rank']}: {k} "
                    f"not launched on the FSDP path")
    f0 = ranks[0]["fsdp"]
    return f0["launches"], {
        "step_ms": statistics.median(f0["step_ms"][1:] or f0["step_ms"]),
        "state_bytes": f0["state_bytes"], "peak": f0["peak"],
        "predicted_peak": mem["peak_bytes"]}


def _wire(counts, direction):
    return sum(v[direction]["wire"] for v in counts.values()
               if direction in v)


def dp_report(ranks, smi):
    """Print and gate the DP ranks' results."""
    r0 = ranks[0]
    L = DP_LAYERS
    one = r0["one_device"]
    hist = [(round(a, 5), round(b, 4)) for a, b in one["hist"]]
    print(f"  one device (rank 0, global batch {DP_BATCH}): (loss, "
          f"grad_norm) {hist}; step ms "
          f"{[round(t, 1) for t in one['step_ms']]}; card {smi}", flush=True)
    for r in ranks:
        none = r["none"]
        print(f"  rank {r['rank']} (tp {r['tp_rank']}, dp {r['dp_rank']}): "
              f"none (loss, grad_norm) "
              f"{[(round(a, 5), round(b, 4)) for a, b in none['hist']]} "
              f"(tol {TP_LOSS_TOL} / relative {TP_GNORM_RTOL} of one "
              f"device); step ms {[round(t, 1) for t in none['step_ms']]} "
              f"(gloo through host memory, four ranks on one card: no "
              f"measure of NCCL or of the paper's claim)", flush=True)
        for (la, ga), (lb, gb) in zip(none["hist"], one["hist"]):
            require(abs(la - lb) <= TP_LOSS_TOL
                    and abs(ga - gb) <= TP_GNORM_RTOL * gb,
                    "DP training disagrees with one device")
        for method in DP_METHODS:
            for c in r[method]["counts"]:
                require(_ar(c, "data") == 1 and _ar(c, "data", "bytes")
                        == 4 * r["n_local"] and _ar(c, "metric") == 1,
                        f"{method}: DP all-reduces a step {c}")
        base = r["none"]["counts"][0]
        base_fwd = {k: v["forward"] for k, v in base.items()
                    if "forward" in v}
        w_none = _wire(base, "backward")
        for method in DP_METHODS[1:]:
            res = r[method]
            c = res["counts"][0]
            fwd = {k: v["forward"] for k, v in c.items() if "forward" in v}
            ratio = _wire(c, "backward") / w_none
            kinds = {k: v["backward"]["calls"] for k, v in c.items()
                     if "backward" in v}
            print(f"  rank {r['rank']}: {method}: (loss, grad_norm) "
                  f"{[(round(a, 5), round(b, 4)) for a, b in res['hist']]};"
                  f" first-step gradient vs none: relative error "
                  f"{res['grad_err']:.4e}; backward wire bytes "
                  f"{_wire(c, 'backward')} vs none {w_none} (ratio "
                  f"{ratio:.4f}); backward calls {kinds}; step ms "
                  f"{[round(t, 1) for t in res['step_ms']]}",
                  flush=True)
            require(fwd == base_fwd, f"{method}: forward collectives differ "
                    f"from none's")
            require(ratio <= DP_INT8_WIRE if method == "int8" else
                    ratio < 1, f"{method}: backward wire ratio {ratio:.4f}")
            require(all(math.isfinite(a) for a, _ in res["hist"]),
                    f"{method}: loss not finite")
        print(f"  rank {r['rank']}: DP all-reduce {4 * r['n_local']} B "
              f"(the local fp32 gradient) over gloo through host memory: "
              f"{[round(t, 1) for t in r['dp_all_reduce_ms']]} ms (host "
              f"clock); peak {r['peak'] / 2**30:.2f} GiB; launches "
              f"{r['launches']}; paths {r['paths']}; card {smi}", flush=True)
        from repro_torch.kernels import ops
        require(set(r["paths"].values()) == {ops.CUDA}
                and {"flash_attention", "fused_ln_add"} <= set(r["paths"]),
                f"rank {r['rank']}: DP paths {r['paths']}")
        passes = len(DP_METHODS) * DP_STEPS
        want = {"flash_attention": 2 * passes * L,
                "flash_attention.bwd": passes * L}
        got = {k: r["launches"].get(k, 0) for k in want}
        require(got == want, f"DP launches {got} != {want}")
        for k in ("fused_ln_add", "fused_ln_add.bwd"):
            require(r["launches"].get(k, 0) > 0, f"rank {r['rank']}: {k} "
                    f"not launched on the DP paths")
    require(len({tuple(r["none"]["hist"]) for r in ranks}) == 1,
            "DP losses differ across ranks")
    print(f"  checkpoint: {r0['ckpt_leaves']} leaves, {r0['ckpt_bytes']} B "
          f"written by rank 0 (gathered over TP); save "
          f"{[round(r['save_s'], 2) for r in ranks]} s by rank (gather + "
          f"write + barrier), restore into one device on the card "
          f"{r0['restore_s']:.2f} s; bit-equal to the gathered state: "
          f"{r0['ckpt_equal']}; card {smi}", flush=True)
    require(r0["ckpt_equal"] and r0["ckpt_on_card"],
            "the tp x dp checkpoint does not restore bit for bit")
    # the first step carries each rank's warm-up: the median of the rest
    summary = {"step_ms": statistics.median(r0["none"]["step_ms"][1:]),
               "dp_all_reduce_ms": statistics.median(
                   r0["dp_all_reduce_ms"]),
               "save_s": r0["save_s"], "restore_s": r0["restore_s"]}
    return r0["launches"], summary


# --------------------------------------------------------------------------- #
# gemma2: sliding windows, logit softcaps, checkpoints
# --------------------------------------------------------------------------- #
#: the window of the card-vs-CPU ticks (the config's 4096 replaced), so that
#: it binds on lanes of ~300 tokens
G2_TICK_WINDOW = 128
#: the card-vs-CPU train step's sequence: past the window, so that it
#: binds on the local layer (320 until the sequence-cut decode check
#: joined phase 13b, 192 until the ssm / hybrid / audio families' TP part
#: joined phase 13a; the CPU side's fp32 step over 2.3 B parameters set
#: the gemma2 phases' time)
G2_TICK_TRAIN_S = 144
#: gemma2 training: B x S tokens (S past the local layers' 4096 window)
G2_TRAIN_B, G2_TRAIN_S = 1, 6144


def gemma2_config(**kw):
    """gemma2-27b at full width, cut to 2 layers: block 0 local (window
    4096), block 1 global."""
    from repro_torch.configs.base import get_config
    return get_config("gemma2-27b").replace(n_layers=2, **kw)


def gemma2_tick_phase():
    """gemma2-27b at full width (2 layers, fp32, window 128): one packed
    tick, one padded chunk tick, one padded decode tick and one contiguous
    decode tick over a random history, then one train step (B=1,
    S=G2_TICK_TRAIN_S),
    each on the card against the CPU.  Every layer takes the gather branch
    (the softcap is on in all of them): the card's only kernel on the
    serving ticks is the LN-add."""
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = gemma2_config(dtype="float32", sliding_window=G2_TICK_WINDOW)
    phase(f"gemma2-27b ticks at full width, 2 layers, fp32, window "
          f"{G2_TICK_WINDOW}: card vs CPU")
    t0 = time.perf_counter()
    # drawn on the card (seconds faster than the CPU's generator), then
    # copied to the CPU: both sides start from these CPU weights
    params = interop.tree_to(M.init_params(cfg, seed=0, device="cuda",
                                           dtype="float32"), "cpu")
    torch.cuda.empty_cache()
    print(f"  init_params on the card, copied to the CPU: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ln = {"fused_ln_add": ops.CUDA}
    packed_tick(cfg, params, want_paths=ln, scaled_tol=True)
    padded_tick(cfg, params, "gemma2-27b chunk tick C=128", 128,
                ((0, 128), (172, 128), (300, 37), (250, 0), (0, 1),
                 (64, 128), (200, 90), (400, 128)), 40, False, ln,
                scaled_tol=True)
    padded_tick(cfg, params, "gemma2-27b decode tick C=1", 1,
                ((0, 1), (127, 1), (128, 1), (300, 1), (511, 1), (100, 0),
                 (200, 1), (129, 1)), 64, False, ln, scaled_tol=True)
    # post-norms: no dual-branch plan
    contiguous_card_vs_cpu(cfg, params, f"gemma2-27b full width, 2 layers, "
                           f"fp32, window {G2_TICK_WINDOW}", G2_CONTIG_LANES,
                           G2_CONTIG_S, 1, plans=("sequential",),
                           scaled_tol=True)
    phase("gemma2-27b: one train step at full width, 2 layers, fp32, B=1, "
          f"S={G2_TICK_TRAIN_S}, window {G2_TICK_WINDOW}: card vs CPU")
    train_tick(cfg, 1, G2_TICK_TRAIN_S, params=params)
    print(f"  gemma2 tick phases: {time.perf_counter() - t0:.1f} s",
          flush=True)


def gemma2_train_phase():
    """``trainer.train`` at gemma2-27b's full width, 2 layers (local, then
    global), fal, fp32 masters, bf16 compute, remat, B=1, S=6144: 1 warm-up
    step and 3 counted steps; one more step under torch.profiler.  (Its
    27.75 GB checkpoint round trip left this phase for the MLA phases'
    time: the data-parallel phase still round-trips a checkpoint on the
    card and ``tests/test_torch_checkpoint.py`` holds the format.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import window_schedule
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train import trainer
    cfg = gemma2_config()
    steps, B, S = 4, G2_TRAIN_B, G2_TRAIN_S
    phase(f"train: gemma2-27b, 2 layers (windows {window_schedule(cfg)}), "
          f"{cfg.connection}, fp32 masters, {cfg.dtype} compute, remat "
          f"{cfg.remat}, B={B}, S={S}, {steps - 1} steps after 1 warm-up")
    marks = []

    def mark(i, state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if i == 0:                       # the warm-up step is not counted
            ops.reset_launches()
            ops.reset_dispatch_paths()
            torch.cuda.reset_peak_memory_stats()

    t_train = time.perf_counter()
    state, hist = trainer.train(cfg, steps=steps, batch=B, seq_len=S,
                                log_every=1, device="cuda", callbacks=[mark])
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms)
    print(f"  losses {['%.4f' % x for x in losses]}; step ms "
          f"{['%.1f' % x for x in step_ms]} (median {ms:.1f}); "
          f"{B * S / ms * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated, counted "
          f"steps); train {time.perf_counter() - t_train:.1f} s")
    n, L = steps - 1, cfg.n_layers
    want = {"flash_attention": n * L * 2, "flash_attention.bwd": n * L,
            "fused_ln_add": n * L * 2, "fused_ln_add.bwd": n * L}
    print(f"  launches {dict((k, counts[k]) for k in want)} (expected "
          f"steps x layers x remat factor 2 forward, steps x layers "
          f"backward: {want}); paths {paths}", flush=True)
    require(all(math.isfinite(x) for x in losses), "non-finite loss")
    require(all(counts[k] == v for k, v in want.items()),
            "gemma2 train launches != their products")
    require(paths == {"flash_attention": ops.CUDA,
                      "fused_ln_add": ops.CUDA},
            f"gemma2 train paths {paths}")
    ocfg = adamw.AdamWConfig(lr=3e-4)
    step = tstep.make_train_step(cfg, ocfg)
    g = torch.Generator().manual_seed(17)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32).cuda()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    step_peak = torch.cuda.max_memory_allocated()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    device_ms = sum(r[1] for r in rows)
    flash = [(re.search(r"(\w+<[^>]*>)\(", key).group(1), kms, c)
             for key, kms, c in rows
             if re.search(r"tc::\w+_kernel<|flash_\w+_kernel<", key)]
    flash_ms = sum(r[1] for r in flash)
    if device_ms == 0.0:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels)")
    else:
        print(f"  profiled step: wall {wall:.1f} ms, device kernel time "
              f"{device_ms:.1f} ms, busy share {device_ms / wall:.3f} "
              f"(of the profiled wall); peak memory "
              f"{step_peak / 2**30:.2f} GiB")
        for key, kms, c in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"    {kms:9.2f} ms {c:6d} calls  {key[:90]}")
        print(f"  flash_attention kernels: {flash_ms:.2f} ms of the "
              f"step's device time ({flash_ms / device_ms:.3f}): "
              + ", ".join(f"{name} {kms:.2f} ms in {c}"
                          for name, kms, c in flash), flush=True)
    del state
    torch.cuda.empty_cache()
    return ({"flash_attention": counts["flash_attention"],
             "flash_attention.bwd": counts["flash_attention.bwd"]},
            dict(step_ms=ms, peak=peak, device_ms=device_ms,
                 flash_ms=flash_ms))


def gemma2_engine_phase():
    """gemma2-27b at full width (2 layers, bf16, the real window of 4096)
    through PagedEngine: 4 greedy requests with prompts of 4200 to 5200
    tokens and 16 new tokens each, twice (the same streams); then three
    ticks of a third serving under torch.profiler (device time a tick,
    peak memory)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import (EngineConfig, PagedEngine,
                                             ServeRequest)
    cfg = gemma2_config()
    phase("engine: gemma2-27b, 2 layers, bf16, window 4096, 4 greedy "
          "requests of 4200..5200 prompt tokens")
    params = M.init_params(cfg, seed=0)
    ecfg = EngineConfig(page_size=16, num_pages=1400, slots=4,
                        prefill_chunk=256, max_seq=6144,
                        cache_dtype="bfloat16")
    engine = PagedEngine(cfg, params, ecfg)
    rng = np.random.default_rng(24)
    engine.submit(ServeRequest(rid=-1, prompt=rng.integers(0, cfg.vocab, 32),
                               max_new=4))
    engine.run()
    lens = rng.integers(4200, 5201, 4)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]

    def serve(base, max_ticks=None):
        engine.finished.clear()
        engine.reset_stats()
        for i, p in enumerate(prompts):
            engine.submit(ServeRequest(rid=base + i, prompt=p, max_new=16))
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t0 = time.perf_counter()
        done = engine.run(max_ticks=max_ticks)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, done, engine.stats(),
                ops.launch_counts(), ops.dispatch_paths())

    runs = []
    for base in (0, 100):
        wall, done, st, counts, paths = serve(base)
        streams = {r.rid - base: list(map(int, r.generated)) for r in done}
        gen = sum(len(v) for v in streams.values())
        print(f"  run {len(runs) + 1}: {st['ticks']} ticks, {gen} tokens in "
              f"{wall:.2f} s = {gen / wall:.1f} tok/s; engine_dispatch_ms "
              f"p50 {st['dispatch_ms']['p50']:.2f} p99 "
              f"{st['dispatch_ms']['p99']:.2f}; ttft_ms p50 "
              f"{st['ttft_ms']['p50']:.1f}; fused_ln_add launches "
              f"{counts['fused_ln_add']} (ticks x layers = "
              f"{st['ticks'] * cfg.n_layers}); paths {paths}", flush=True)
        require(len(done) == 4 and all(len(v) == 16 and not r.truncated
                                       for r, v in zip(done,
                                                       streams.values())),
                "not every gemma2 request finished with 16 tokens")
        require(counts["fused_ln_add"] == st["ticks"] * cfg.n_layers
                and paths == {"fused_ln_add": ops.CUDA},
                f"gemma2 engine launches {counts} / paths {paths}")
        runs.append(dict(streams=streams, tok_s=gen / wall, wall=wall,
                         ticks=st["ticks"], p50=st["dispatch_ms"]["p50"],
                         launches=counts["fused_ln_add"]))
    same = runs[0]["streams"] == runs[1]["streams"]
    print(f"  prompts {sorted(int(n) for n in lens)} tokens; the two runs' "
          f"streams equal: {same}", flush=True)
    require(same, "two gemma2 engine runs gave different streams")
    engine.finished.clear()
    engine.reset_stats()
    for i, p in enumerate(prompts):
        engine.submit(ServeRequest(rid=200 + i, prompt=p, max_new=16))
    engine.run(max_ticks=2)                # admitted, prefilling
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(max_ticks=2 + n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0.0:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels)")
    else:
        print(f"  {n} prefill ticks profiled: device kernel time "
              f"{device_ms / n:.2f} ms a tick (wall {wall / n:.2f} ms a "
              f"tick, busy share {device_ms / wall:.3f}); peak memory "
              f"{peak / 2**30:.2f} GiB (max_memory_allocated over the "
              f"ticks)")
        for key, kms, c in sorted(rows, key=lambda r: -r[1])[:6]:
            print(f"    {kms / n:9.2f} ms a tick {c:6d} calls  {key[:80]}")
    sys.stdout.flush()
    del engine, params
    torch.cuda.empty_cache()
    return dict(tok_s=runs[0]["tok_s"], p50=runs[0]["p50"],
                tick_device_ms=device_ms / n, peak=peak,
                launches=runs[0]["launches"])


# --------------------------------------------------------------------------- #
# seeded sampling and self-speculative decoding
# --------------------------------------------------------------------------- #
#: per-lane (temperature, top_k, top_p) of the sampler phase: greedy;
#: temperature only and top_k 0 / top_p 0.9 (the full sort); top_k 50 /
#: top_p 0.95 and top_k 64 (the fast path)
SAMPLER_LANES = ((0.0, 0, 1.0), (0.9, 0, 1.0), (0.9, 50, 0.95),
                 (0.8, 0, 0.9), (0.7, 50, 0.95), (1.0, 64, 1.0),
                 (0.9, 50, 0.95), (1.2, 0, 0.9))
SAMPLER_SEEDS = (0, 1, -7, 2 ** 31 - 1, -2 ** 31, 123, 42, -1)
SAMPLER_POS = (0, 17, 100, 255, 1000, 2047, 3, 64)


def sampler_args(n):
    """The sampler phase's per-lane CPU tensors (temps, top_ks, top_ps,
    seeds, positions) for its 8 lanes, each over n positions pos..pos+n-1
    (the (S, n) verify grid flattened as ``make_spec_step`` samples it)."""
    def rep(v, dt):
        return torch.tensor(v, dtype=dt).repeat_interleave(n)
    pos = (torch.tensor(SAMPLER_POS, dtype=torch.int32)[:, None]
           + torch.arange(n, dtype=torch.int32)).reshape(-1)
    return (rep([x[0] for x in SAMPLER_LANES], torch.float32),
            rep([x[1] for x in SAMPLER_LANES], torch.int32),
            rep([x[2] for x in SAMPLER_LANES], torch.float32),
            rep(SAMPLER_SEEDS, torch.int32), pos)


def sampler_phase(cfg, params):
    """The samplers on the card against the CPU, on llama3.2-3b head logits
    (bf16 head, fp32 logits) at S = 8 lanes and at the (8, 4) verify grid:
    the threefry bits and uniforms equal, the full and fast samplers' tokens
    equal, fast = full on the fast-eligible lanes.  Times a call of each
    (CUDA events around one call, L2 flushed before, median of 20).
    Returns {(sampler, rows): ms}."""
    from repro_torch.models import model as M
    from repro_torch.serve import prng
    from repro_torch.serve import sampling as SP
    phase("sampler: seeded sampling over llama3.2-3b's 128256 logits, card "
          "vs CPU")
    V = cfg.vocab
    samplers = {"full": SP.sample_tokens, "fast": SP.fast_sampler(V)}
    g = torch.Generator(device="cuda").manual_seed(23)
    with torch.no_grad():
        h = torch.randn((32, 1, cfg.d_model), generator=g,
                        device="cuda").to(torch.bfloat16)
        logits = M.lm_head(params, cfg, h)[:, 0].float()          # (32, V)
    eligible = torch.tensor([SP.fast_eligible(SP.SamplingParams(*x), V)
                             for x in SAMPLER_LANES])
    times = {}
    for n in (1, 4):
        args = sampler_args(n)
        cuda = tuple(a.cuda() for a in args)
        lg = logits[:8 * n]
        keys = prng.fold_in(prng.prng_key(args[3]), args[4])
        bits = torch.equal(prng.random_bits(keys.cuda(), V).cpu(),
                           prng.random_bits(keys, V))
        uni = torch.equal(prng.uniform(keys.cuda(), V, 1e-20).cpu(),
                          prng.uniform(keys, V, 1e-20))
        toks = {name: (fn(lg, *cuda).cpu(), fn(lg.cpu(), *args))
                for name, fn in samplers.items()}
        elig = eligible.repeat_interleave(n)
        print(f"  {8 * n} rows: bits card = CPU {bits}, uniform card = CPU "
              f"{uni}; tokens card = CPU: full "
              f"{torch.equal(*toks['full'])}, fast "
              f"{torch.equal(*toks['fast'])}; fast = full on the "
              f"{int(elig.sum())} eligible rows "
              f"{torch.equal(toks['fast'][0][elig], toks['full'][0][elig])}"
              f"; full tokens {toks['full'][0].tolist()}", flush=True)
        require(bits and uni, "the card's threefry bits differ from the CPU's")
        for name, (a, b) in toks.items():
            require(torch.equal(a, b), f"{name} sampler: card tokens {a} != "
                    f"CPU tokens {b}")
        require(torch.equal(toks["fast"][0][elig], toks["full"][0][elig]),
                "fast sampler != full sampler on eligible lanes")
        for name, fn in samplers.items():
            times[(name, 8 * n)] = _median_ms(lambda: fn(lg, *cuda), n=20)
    print("  ms a call: " + "; ".join(
        f"{name} at {rows} rows {ms:.3f}" for (name, rows), ms
        in times.items()), flush=True)
    return times


def seeded_workload(vocab, n=10, n_full=2, seed=5):
    """Seeded requests (temperature 0.9, top_k 50, top_p 0.95, seed rid:
    the fast sampler), the last ``n_full`` on the full sort (top_k 0, top_p
    0.9), prompts of 64..256 tokens: [(rid, prompt, SamplingParams)]."""
    import numpy as np
    from repro_torch.serve.sampling import SamplingParams
    rng = np.random.default_rng(seed)
    full = lambda i: i >= n - n_full                          # noqa: E731
    return [(i, rng.integers(0, vocab, int(rng.integers(64, 257))),
             SamplingParams(temperature=0.9, top_k=0 if full(i) else 50,
                            top_p=0.9 if full(i) else 0.95, seed=i))
            for i in range(n)]


def serve_counted(engine, work, max_new):
    """Serve ``work`` [(rid, prompt, sampling or None: greedy)] on
    ``engine`` once, launch
    counters and dispatch paths zeroed just before and read just after.
    Returns (streams, wall s, launches, paths, stats)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import ServeRequest
    engine.finished.clear()
    engine.reset_stats()
    for rid, prompt, sp in work:
        kw = {} if sp is None else {"sampling": sp}
        engine.submit(ServeRequest(rid=rid, prompt=prompt, max_new=max_new,
                                   **kw))
    torch.cuda.synchronize()
    ops.reset_launches()
    ops.reset_dispatch_paths()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(len(done) == len(work) and all(
        not r.truncated and len(r.generated) == max_new for r in done),
        "not every request finished with max_new tokens")
    return ({r.rid: list(map(int, r.generated)) for r in done}, wall,
            ops.launch_counts(), ops.dispatch_paths(), engine.stats())


def warm(engine, vocab, sampling=None):
    """One short request outside every count (cuBLAS handles, allocator
    pools, each sampler variant the runs will use)."""
    import numpy as np
    from repro_torch.serve.scheduler import ServeRequest
    prompt = np.random.default_rng(99).integers(0, vocab, 32)
    for sp in sampling or [None]:
        kw = {} if sp is None else {"sampling": sp}
        engine.submit(ServeRequest(rid=-1, prompt=prompt, max_new=6, **kw))
        engine.run()


def seeded_engine_phase(cfg, params, ecfg):
    """Seeded requests at llama3.2-3b full width and depth, twice through
    one engine: every request finishes, the repeat gives the same streams,
    the card runs the kernels only, one launch of each per layer per tick.
    Returns the packed kernel's launches in the first run."""
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import PagedEngine
    L = cfg.n_layers
    phase(f"seeded engine: llama3.2-3b, {L} layers, bf16, 8 seeded + 2 "
          f"full-sort requests, twice")
    work = seeded_workload(cfg.vocab)
    engine = PagedEngine(cfg, params, ecfg)
    warm(engine, cfg.vocab, [work[0][2], work[-1][2]])
    runs = [serve_counted(engine, work, 24) for _ in range(2)]
    for streams, wall, counts, paths, st in runs:
        gen = sum(map(len, streams.values()))
        print(f"  {st['ticks']} ticks, {gen} tokens in {wall:.2f} s = "
              f"{gen / wall:.1f} tok/s; engine_dispatch_ms p50 "
              f"{st['dispatch_ms']['p50']:.2f}; launches {counts}; paths "
              f"{paths}", flush=True)
        require(paths == {"paged_packed_attention": ops.CUDA,
                          "fused_ln_add": ops.CUDA},
                f"seeded engine did not run the kernels only: {paths}")
        require(counts["paged_packed_attention"] == st["ticks"] * L
                and counts["fused_ln_add"] == st["ticks"] * L
                and sum(counts.values()) == 2 * st["ticks"] * L,
                f"seeded engine launches {counts} != ticks x layers")
    require(runs[0][0] == runs[1][0], "the seeded repeat's streams differ")
    print(f"  repeat: the same streams ({len(work)} requests)", flush=True)
    return runs[0][2]["paged_packed_attention"]


def late_block_damped(params, draft_blocks, scale=0.02):
    """The port's copy of ``benchmarks/bench_serving.py:260``
    (``_late_block_damped``): the residual-writing projections (attention
    and FFN ``wo``) of the stacked blocks the draft skips (index >=
    draft_blocks - 1) times ``scale``, so that the shallow draft agrees with
    the full model as it would on trained weights.  Other leaves are
    shared with ``params``."""
    def damp(tree):
        return {k: damp(v) if isinstance(v, dict)
                else v * scale if k == "wo" else v for k, v in tree.items()}
    keep = draft_blocks - 1
    return dict(params, blocks=[pb if i < keep else damp(pb)
                                for i, pb in enumerate(params["blocks"])])


#: speculative ticks profiled: the profiler's processing costs about 1.5 s
#: a 28-layer spec tick, so a few steady-state ticks, not a whole run
SPEC_PROFILED_TICKS = 3


def spec_tick_device_ms(engine, reqs, max_new, profile, activity, kind):
    """Device time of a steady-state speculative tick: serve ``reqs`` once
    more, step plainly until every admitted lane decodes, then profile
    SPEC_PROFILED_TICKS ticks (kernels only) in which every live lane
    speculates.  Returns ms a tick (the sum of the kernels' own times)."""
    from repro_torch.serve.scheduler import ServeRequest
    engine.finished.clear()
    for rid, prompt, sp in reqs:
        kw = {} if sp is None else {"sampling": sp}
        engine.submit(ServeRequest(rid=rid, prompt=prompt, max_new=max_new,
                                   **kw))
    while engine.queue or any(r is not None and not r.generated
                              for r in engine.slots):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[activity.CUDA]) as prof:
        for _ in range(SPEC_PROFILED_TICKS):
            engine.step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == kind.CUDA]
    dev = sum(ms for _, ms, _ in rows)
    engine.run()
    ms = dev / SPEC_PROFILED_TICKS
    print(f"  seeded spec tick device time {ms:.2f} ms ("
          f"{SPEC_PROFILED_TICKS} profiled ticks, every lane speculating; "
          f"{wall / SPEC_PROFILED_TICKS:.1f} ms of wall a tick under the "
          f"profiler)", flush=True)
    for key, kms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    {kms / SPEC_PROFILED_TICKS:8.3f} ms a tick {n:6d} calls  "
              f"{key[:90]}")
    return ms


def spec_engine_phase(cfg, params, ecfg):
    """Self-speculative decoding at llama3.2-3b full width and depth
    (spec_tokens=4, draft_blocks=2), greedy on the random weights and
    seeded on late-block-damped weights, each run twice (then a few seeded
    ticks under torch.profiler).  Every request finishes, one model call a
    tick, the kernels only (verify and .draft sites), packed and LN-add
    launches
    = ticks x layers + draft iterations x draft_blocks, the repeat gives the
    same streams, and the damped draft's proposals are accepted.  Reports
    acceptance, tok/s against the non-spec engine on the same weights and
    the common-prefix fraction of the streams against a non-spec engine of
    the same token budget (not gated: bf16 on the card, another M for the
    GEMMs).  Returns {"launches", "formula", "device_ms_per_tick"}."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serve import scheduler as SCH
    L, n, db = cfg.n_layers, 4, 2
    phase(f"spec engine: llama3.2-3b, {L} layers, bf16, spec_tokens={n}, "
          f"draft_blocks={db}, greedy (random) and seeded (damped)")
    spec_cfg = dataclasses.replace(ecfg, spec_tokens=n, draft_blocks=db)
    draws = []
    draft = SCH.M.paged_spec_draft

    def counted(*a, **kw):
        draws.append(1)
        return draft(*a, **kw)

    want_paths = {site: ops.CUDA for site in (
        "paged_packed_attention", "fused_ln_add",
        "paged_packed_attention.draft", "fused_ln_add.draft")}
    # the reference bench's spec workload sampling: every lane top_k 50
    work = seeded_workload(cfg.vocab, n=8, n_full=0, seed=6)
    greedy = [(rid, prompt, None) for rid, prompt, _ in work]
    out = {}
    SCH.M.paged_spec_draft = counted
    try:
        for name, weights, reqs in (
                ("greedy", params, greedy),
                ("seeded", late_block_damped(params, db), work)):
            engine = SCH.PagedEngine(cfg, weights, spec_cfg)
            warm(engine, cfg.vocab, [r[2] for r in reqs[:1]])
            plain = SCH.PagedEngine(cfg, weights, dataclasses.replace(
                ecfg, token_budget=engine.budget))
            warm(plain, cfg.vocab, [r[2] for r in reqs[:1]])
            runs = []
            for rep in range(2):
                draws.clear()
                runs.append(serve_counted(engine, reqs, 48))
                streams, wall, counts, paths, st = runs[-1]
                ticks, iters = st["ticks"], len(draws)
                formula = ticks * L + iters * db
                sp_st = st["spec"]
                gen = sum(map(len, streams.values()))
                print(f"  [{time.perf_counter() - _T0:.1f} s] {name} run "
                      f"{rep}: {ticks} ticks, {iters} draft "
                      f"iterations ({iters // (n - 1)} ticks with a spec "
                      f"lane), {gen} tokens in {wall:.2f} s = "
                      f"{gen / wall:.1f} tok/s; acceptance "
                      f"{sp_st['acceptance_rate']:.3f}, accepted_len p50 "
                      f"{sp_st['accepted_len']['p50']} mean "
                      f"{sp_st['accepted_len']['mean']:.2f}; "
                      f"dispatches_per_tick {st['dispatches_per_tick']}; "
                      f"launches {counts} (ticks x {L} + draft iterations x "
                      f"{db} = {formula}); paths {paths}", flush=True)
                require(st["dispatches_per_tick"] == 1.0,
                        f"{name}: dispatches_per_tick "
                        f"{st['dispatches_per_tick']}")
                require(paths == want_paths, f"{name}: paths {paths}")
                require(iters % (n - 1) == 0 and counts[
                    "paged_packed_attention"] == formula
                    and counts["fused_ln_add"] == formula
                    and sum(counts.values()) == 2 * formula,
                    f"{name}: launches {counts} != ticks x {L} + draft "
                    f"iterations x {db} = {formula}")
            require(runs[0][0] == runs[1][0],
                    f"{name}: the repeat's streams differ")
            if name == "seeded":
                out["device_ms_per_tick"] = spec_tick_device_ms(
                    engine, reqs, 48, profile, ProfilerActivity, DeviceType)
            ref = serve_counted(plain, reqs, 48)
            common = [common_prefix(runs[0][0][rid], ref[0][rid])
                      / len(ref[0][rid]) for rid in ref[0]]
            gen = sum(map(len, ref[0].values()))
            spec_tok_s = sum(map(len, runs[0][0].values())) / runs[0][1]
            print(f"  [{time.perf_counter() - _T0:.1f} s] {name}: non-spec "
                  f"engine (token_budget {plain.budget}) {ref[4]['ticks']} "
                  f"ticks, {gen / ref[1]:.1f} tok/s against the spec "
                  f"engine's {spec_tok_s:.1f} "
                  f"(x{spec_tok_s * ref[1] / gen:.2f}, no claim: one run "
                  f"each); spec streams equal "
                  f"{sum(runs[0][0][k] == v for k, v in ref[0].items())}/"
                  f"{len(ref[0])}, mean common-prefix fraction "
                  f"{statistics.mean(common):.3f}", flush=True)
            out[name] = runs[0]
            del engine, plain
            torch.cuda.empty_cache()
    finally:
        SCH.M.paged_spec_draft = draft
    first = out["seeded"]
    require(first[4]["spec"]["proposals_accepted"] > 0,
            "no proposal accepted on the damped weights")
    return {"launches": first[2]["paged_packed_attention"],
            "ln_launches": first[2]["fused_ln_add"],
            "formula": f"ticks x {L} + draft iterations x {db}",
            "device_ms_per_tick": out["device_ms_per_tick"]}


# --------------------------------------------------------------------------- #
# the MoE family: qwen3-moe-30b-a3b (and one deepseek-v3 MoE layer)
# --------------------------------------------------------------------------- #
MOE_ARCH = "qwen3-moe-30b-a3b"
#: the engine serves the whole model: 48 layers, 60.4 GB of bf16 weights
MOE_ENGINE_LAYERS = 48
#: (16 new tokens a request since the ssm / hybrid / audio families' TP
#: part joined phase 13a; 32 before)
MOE_ENGINE_REQS, MOE_ENGINE_PROMPT, MOE_ENGINE_NEW = 16, (64, 512), 16
MOE_PROFILED_TICKS = 2
MOE_CONTIG_TICKS = 4
MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 1, 2048, 4
#: the card-vs-CPU train step's and the TP / EP spawn's sequences (256 and
#: 1024 until the ssm / hybrid / audio families' TP part joined phase 13a:
#: the CPU side's fp32 experts and the gloo ranks' steps set their time)
MOE_TICK_TRAIN_S = 128
MOE_TP_SEQ = 512
#: the ticks' lanes (llama3.2-3b's, tick_phase): (pos, n_valid)
MOE_CHUNK_LANES = ((0, 128), (128, 128), (256, 37), (300, 0), (0, 1),
                   (64, 128), (200, 90), (500, 128))
MOE_DECODE_LANES = ((0, 1), (15, 1), (16, 1), (300, 1), (511, 1), (100, 0),
                    (200, 1), (63, 1))
#: expert parallelism over two ranks: {case: (arch, path, tokens a rank)}.
#: Capacity is per source shard there, so the sharded paths equal the
#: one-device moe_apply only where nothing drops: each case sets its
#: capacity factor so that nothing can (``ep_config``)
MOE_EP_CASES = {"qwen3-moe layer, moe_apply_sharded":
                (MOE_ARCH, "sharded", 512),
                "deepseek-v3 layer, moe_apply_shard_slot":
                ("deepseek-v3-671b", "shard_slot", 128)}
#: bf16 gates of the EP paths against moe_apply on one device: the same
#: expert products over other batches of rows (cuBLAS may sum them in
#: another order) and, shard-slot, the weighted sum taken per rank and then
#: across ranks: a few bf16 ulps of the output's largest magnitude; the
#: input gradient through bf16 autograd, relative to its largest magnitude
MOE_EP_ULPS = 8
MOE_EP_GRAD_RTOL = 5e-2
#: gates of the MoE TP phase, fp32 compute on both sides (bf16 router logits
#: tie often, and a token routed otherwise at a tie moves every later
#: position's logits through attention): the partial sums reassociate fp32
#: sums (~1e-6 relative) -> the fp32 tick gate on logits of order 1; the
#: trainer step's loss and aux within 1e-4 (``train_tick``'s) and its grad
#: norm within 1e-3 relative
MOE_TP_LOGIT_TOL, MOE_TP_LOSS_TOL, MOE_TP_GNORM_RTOL = 1e-3, 1e-4, 1e-3


def moe_config(**kw):
    from repro_torch.configs.base import get_config
    return get_config(MOE_ARCH).replace(**kw)


def moe_tick_phase():
    """qwen3-moe-30b-a3b at full width, 2 layers (both MoE), fp32: one
    packed tick, one padded chunk tick, one padded C == 1 tick under the
    dual-branch plan (MoE blocks take the unfused route: no fused launch),
    MOE_CONTIG_TICKS contiguous decode ticks, and one train step (B=1,
    S=256), each on the card against the CPU with the routing compared
    (``route_flips``): a token may choose other experts only at a near tie,
    and such a token's sequence is left out of the gate."""
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = moe_config(n_layers=2, dtype="float32")
    L, cuda = cfg.n_layers, ops.CUDA
    phase(f"{MOE_ARCH} ticks at full width, {L} layers, fp32: card vs CPU")
    t0 = time.perf_counter()
    params = interop.tree_to(M.init_params(cfg, seed=0, device="cuda",
                                           dtype="float32"), "cpu")
    torch.cuda.empty_cache()
    print(f"  init_params on the card, copied to the CPU: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counts = packed_tick(cfg, params, scaled_tol=True, moe=True)
    require(counts["paged_packed_attention"] == L
            and counts["fused_ln_add"] == L,
            f"MoE packed tick launches {nonzero(counts)}")
    padded_tick(cfg, params, "qwen3-moe chunk tick C=128", 128,
                MOE_CHUNK_LANES, 40, False,
                {"paged_chunk_attention": cuda, "fused_ln_add": cuda},
                scaled_tol=True, moe=True)
    counts = padded_tick(cfg, params, "qwen3-moe dual-branch decode tick C=1",
                         1, MOE_DECODE_LANES, 64, True,
                         {"paged_decode_attention": cuda,
                          "fused_ln_add": cuda}, scaled_tol=True, moe=True)
    require(counts["fused_dual_branch_decode"] == 0
            and counts["paged_decode_attention"] == L,
            f"MoE dual C == 1 tick launches {nonzero(counts)}: MoE blocks "
            f"must take the unfused route")
    contiguous_card_vs_cpu(cfg, params, f"{MOE_ARCH} full width, {L} "
                           f"layers, fp32", CONTIG_LANES, CONTIG_S,
                           MOE_CONTIG_TICKS, scaled_tol=True, moe=True)
    phase(f"{MOE_ARCH}: one train step at full width, {L} layers, fp32, "
          f"B=1, S={MOE_TICK_TRAIN_S}: card vs CPU")
    train_tick(cfg, 1, MOE_TICK_TRAIN_S, params=params, moe=True)
    del params
    print(f"  MoE tick phases: {time.perf_counter() - t0:.1f} s", flush=True)


def moe_engine_phase():
    """qwen3-moe-30b-a3b at full width and depth (48 layers, bf16) through
    PagedEngine: MOE_ENGINE_REQS greedy requests, the counters zeroed just
    before and read just after; then MOE_PROFILED_TICKS prefill ticks of the
    same workload under torch.profiler (device time, busy share) and
    ``moe.counting_drops`` (the share of (token, expert) pairs over
    capacity); then the workload through ``EngineConfig(dual_branch=True)``:
    the same streams, and no fused dual-branch launch (MoE blocks)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe as MO
    from repro_torch.optim import adamw
    from repro_torch.serve.scheduler import (EngineConfig, PagedEngine,
                                             ServeRequest)
    cfg = moe_config(n_layers=MOE_ENGINE_LAYERS)
    L, (lo, hi), new = cfg.n_layers, MOE_ENGINE_PROMPT, MOE_ENGINE_NEW
    phase(f"engine: {MOE_ARCH}, {L} layers, bf16, {MOE_ENGINE_REQS} greedy "
          f"requests of {lo}..{hi} prompt tokens + {new}")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for _, t in adamw.named_leaves(params))
    print(f"  init_params on the card: {time.perf_counter() - t0:.1f} s; "
          f"{n_par / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    kw = dict(page_size=16, num_pages=1024, slots=8, prefill_chunk=256,
              max_seq=2048, cache_dtype="bfloat16")
    rng = np.random.default_rng(28)
    lens = rng.integers(lo, hi + 1, MOE_ENGINE_REQS)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]

    def serve(engine, base):
        engine.finished.clear()
        engine.reset_stats()
        for i, p in enumerate(prompts):
            engine.submit(ServeRequest(rid=base + i, prompt=p, max_new=new))
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts, paths, st = (ops.launch_counts(), ops.dispatch_paths(),
                             engine.stats())
        streams = {r.rid - base: list(map(int, r.generated)) for r in done}
        gen = sum(len(v) for v in streams.values())
        print(f"  {'dual' if engine.plan.dual_branch else 'sequential'}: "
              f"ticks {st['ticks']}, {gen} tokens in {wall:.2f} s = "
              f"{gen / wall:.1f} tok/s; engine_dispatch_ms p50 "
              f"{st['dispatch_ms']['p50']:.2f} p99 "
              f"{st['dispatch_ms']['p99']:.2f}; ttft_ms p50 "
              f"{st['ttft_ms']['p50']:.1f}; peak pages "
              f"{st['pages']['peak_in_use']}/{st['pages']['capacity']}; "
              f"launches {nonzero(counts)} (ticks x layers = "
              f"{st['ticks'] * L}); paths {paths}", flush=True)
        require(len(streams) == MOE_ENGINE_REQS
                and all(len(v) == new for v in streams.values()),
                f"not every MoE request finished with {new} tokens")
        require(counts["paged_packed_attention"] == st["ticks"] * L
                and counts["fused_ln_add"] == st["ticks"] * L
                and counts["fused_dual_branch_decode"] == 0
                and sum(counts.values()) == 2 * st["ticks"] * L,
                f"MoE engine launches {nonzero(counts)} != ticks x layers")
        require(paths == {"paged_packed_attention": ops.CUDA,
                          "fused_ln_add": ops.CUDA},
                f"MoE engine paths {paths}")
        return dict(streams=streams, tok_s=gen / wall, wall=wall,
                    ticks=st["ticks"], p50=st["dispatch_ms"]["p50"],
                    p99=st["dispatch_ms"]["p99"],
                    launches=counts["paged_packed_attention"],
                    ln_launches=counts["fused_ln_add"])

    engine = PagedEngine(cfg, params, EngineConfig(**kw))
    engine.submit(ServeRequest(rid=-1, prompt=rng.integers(0, cfg.vocab, 32),
                               max_new=4))
    engine.run()
    seq = serve(engine, 0)
    # where a tick's time goes: prefill ticks of the same workload
    engine.finished.clear()
    engine.reset_stats()
    for i, p in enumerate(prompts):
        engine.submit(ServeRequest(rid=100 + i, prompt=p, max_new=new))
    engine.run(max_ticks=1)                # admitted, prefilling
    torch.cuda.synchronize()
    n = MOE_PROFILED_TICKS
    with MO.counting_drops() as drops, profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.run(max_ticks=1 + n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    summed = sum(r[1] for r in rows)
    drop_share = int(drops["dropped"]) / max(drops["pairs"], 1)
    prof_out = dict(drop_share=drop_share, pairs=drops["pairs"] // n)
    if summed == 0.0:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels)")
    else:
        busy = busy_ms(prof) / n
        prof_out.update(device_ms=busy, busy=busy / (wall / n),
                        wall_ms=wall / n)
        print(f"  {n} prefill ticks profiled: device time {busy:.2f} ms a "
              f"tick busy (kernel times summed {summed / n:.2f}), wall "
              f"{wall / n:.2f} ms a tick (profiled), busy share "
              f"{busy / (wall / n):.3f}; dropped (token, expert) pairs "
              f"{int(drops['dropped'])} of {drops['pairs']} = "
              f"{drop_share:.4f} (capacity factor {cfg.capacity_factor})")
        for key, kms, c in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"    {kms / n:9.2f} ms a tick {c:6d} calls  {key[:80]}")
    sys.stdout.flush()
    del engine
    torch.cuda.empty_cache()
    engine = PagedEngine(cfg, params, EngineConfig(**kw, dual_branch=True))
    dual = serve(engine, 200)
    same = dual["streams"] == seq["streams"]
    print(f"  dual-branch streams equal the sequential engine's: {same}",
          flush=True)
    require(same, "the MoE dual-branch engine's streams differ")
    del engine, params
    torch.cuda.empty_cache()
    return dict(seq, streams=None, dual_tok_s=dual["tok_s"], **prof_out)


def moe_train_phase():
    """``trainer.train`` at qwen3-moe-30b-a3b's full width, 2 layers (both
    MoE: 1.56 B parameters), fal, fp32 masters, bf16 compute, remat, B=1,
    S=2048: one warm-up step and MOE_TRAIN_STEPS - 1 counted steps, then
    one step under torch.profiler and ``moe.counting_drops``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MO
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train import trainer
    cfg = moe_config(n_layers=2)
    steps, B, S, L = MOE_TRAIN_STEPS, MOE_TRAIN_B, MOE_TRAIN_S, cfg.n_layers
    phase(f"train: {MOE_ARCH}, {L} layers, {cfg.connection}, fp32 masters, "
          f"{cfg.dtype} compute, remat {cfg.remat}, B={B}, S={S}, "
          f"{steps - 1} steps after 1 warm-up")
    marks = []

    def mark(i, state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if i == 0:
            ops.reset_launches()
            ops.reset_dispatch_paths()
            torch.cuda.reset_peak_memory_stats()

    state, hist = trainer.train(cfg, steps=steps, batch=B, seq_len=S,
                                log_every=1, device="cuda", callbacks=[mark])
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    peak = torch.cuda.max_memory_allocated()
    n_par = sum(t.numel() for _, t in adamw.named_leaves(state["params"]))
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms)
    n = steps - 1
    want = {"flash_attention": n * L * 2, "flash_attention.bwd": n * L,
            "fused_ln_add": n * L * 2, "fused_ln_add.bwd": n * L}
    print(f"  {n_par / 1e9:.3f} B parameters; (loss, ce, aux) "
          f"{[(round(h['loss'], 4), round(h['ce'], 4), round(h['aux'], 4)) for h in hist]}; "
          f"step ms {['%.1f' % x for x in step_ms]} (median {ms:.1f}); "
          f"{B * S / ms * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated, counted steps); "
          f"launches {dict((k, counts[k]) for k in want)} (want {want}); "
          f"paths {paths}", flush=True)
    require(all(math.isfinite(h[k]) for h in hist
                for k in ("loss", "ce", "aux")) and hist[-1]["aux"] > 0,
            "MoE train: a non-finite loss, ce or aux")
    require(all(counts[k] == v for k, v in want.items()),
            "MoE train launches != their products")
    require(paths == {"flash_attention": ops.CUDA, "fused_ln_add": ops.CUDA},
            f"MoE train paths {paths}")
    step = tstep.make_train_step(cfg, adamw.AdamWConfig(lr=3e-4))
    g = torch.Generator().manual_seed(29)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32).cuda()}
    torch.cuda.synchronize()
    with MO.counting_drops() as drops, profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device_ms = busy_ms(prof)
    # remat runs each forward twice: both runs route the same pairs
    drop_share = int(drops["dropped"]) / max(drops["pairs"], 1)
    out = dict(step_ms=ms, tok_s=B * S / ms * 1e3, peak=peak,
               drop_share=drop_share, n_params=n_par)
    if device_ms == 0.0:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels)")
    else:
        out.update(device_ms=device_ms, busy=device_ms / wall)
        print(f"  profiled step: wall {wall:.1f} ms, device time "
              f"{device_ms:.1f} ms busy, busy share {device_ms / wall:.3f}; "
              f"dropped (token, expert) pairs {drop_share:.4f} of "
              f"{drops['pairs']} routed (capacity factor "
              f"{cfg.capacity_factor})", flush=True)
    del state
    torch.cuda.empty_cache()
    return ({k: counts[k] for k in want}, out)


def ep_config(arch):
    """The case's layer config with a capacity factor of E / k: then C =
    T for any T (no expert can take more than every token), so neither the
    one-device oracle nor a source shard drops a pair; shard-slot's second
    stage (C2 = 2 ceil(M T k / E cf)) then holds all M T rows too."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k,
                       dtype="bfloat16")


def ep_weights(cfg, lo, hi, dev, seed=5):
    """Experts [lo, hi) of a MoE layer and its router (and shared expert),
    bf16 on ``dev``: each expert drawn from its own seed, so a rank draws
    only its own and the one-device oracle draws them all alike."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    g = torch.Generator(device=dev)
    bf = torch.bfloat16

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=g, device=dev)
                / math.sqrt(fan_in)).to(bf)
    p = {k: torch.empty((hi - lo,) + s, dtype=bf, device=dev)
         for k, s in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    for e in range(lo, hi):
        g.manual_seed(seed * 1_000_003 + e)
        p["wi"][e - lo] = normal((d, f), d)
        p["wg"][e - lo] = normal((d, f), d)
        p["wo"][e - lo] = normal((f, d), f)
    g.manual_seed(seed * 1_000_003 - 1)
    p["router"] = normal((d, E), d)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"wi": normal((d, fs), d), "wg": normal((d, fs), d),
                       "wo": normal((fs, d), fs)}
    return p


def ep_inputs(cfg, T, dev):
    """x and the output gradient (1, T, d), bf16, from fixed seeds."""
    g = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn((1, T, cfg.d_model), generator=g, device=dev)
    dy = torch.randn((1, T, cfg.d_model), generator=g, device=dev)
    return x.to(torch.bfloat16), dy.to(torch.bfloat16)


def ep_oracle(path):
    """``moe_apply`` on one device for each MOE_EP_CASES case over both
    ranks' tokens: its output, the input's gradient and its routing (the
    experts and probabilities) saved (on the host) to ``path`` for the
    ranks; no pair may drop."""
    from repro_torch.models import moe as MO
    refs = {}
    for name, (arch, _, t_rank) in MOE_EP_CASES.items():
        cfg = ep_config(arch)
        t0 = time.perf_counter()
        p = ep_weights(cfg, 0, cfg.n_experts, "cuda")
        x, dy = ep_inputs(cfg, TP_SIZE * t_rank, "cuda")
        x.requires_grad_(True)
        with MO.counting_drops() as drops, MO.recording_routes() as routes:
            y, _ = MO.moe_apply(p, cfg, x)
        y.backward(dy)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in (p["wi"], p["wg"], p["wo"],
                                         p["router"]))
        n_par += sum(t.numel() for t in p.get("shared", {}).values())
        (e, probs), = routes
        refs[name] = (y.detach().cpu(), x.grad.cpu(), e.cpu(), probs.cpu())
        print(f"  {name}: {n_par / 1e9:.2f} B parameters "
              f"({2 * n_par / 1e9:.1f} GB bf16) on one device, "
              f"{int(drops['dropped'])} of {drops['pairs']} pairs dropped "
              f"(capacity factor {cfg.capacity_factor:g}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        require(int(drops["dropped"]) == 0, "the EP oracle dropped pairs")
        del p, x, y, dy
        torch.cuda.empty_cache()
    torch.save(refs, path)


def moe_rank(group, oracle_path):
    """One rank of the MoE TP / EP phase (spawned by ``core.tp.run_ranks``).
    Explicit TP at qwen3-moe-30b-a3b's full width, 2 layers, 64 experts a
    rank, fp32 compute: the one-device references first (logits and their
    routing; on rank 0 one trainer step), then with the counters zeroed the
    TP forward (its routing against one device's: positions from the first
    token routed otherwise at a near tie on are left out of the logits
    gate, B = 1) and one TP trainer step.  Expert parallelism: each MOE_EP_CASES case on this
    rank's tokens and experts, forward and backward, against the oracle.
    Returns numbers only."""
    import torch.distributed as dist
    from repro_torch.core import tp
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as MX
    from repro_torch.models import model as M
    from repro_torch.models import moe as MO
    from repro_torch.train import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, size = dist.get_rank(), dist.get_world_size()
    dev = tp_device(rank)
    out = {"rank": rank, "device": str(dev)}
    plan = ExecutionPlan.from_group(group, tp="explicit")
    cfg = moe_config(n_layers=2, dtype="float32")
    g = torch.Generator().manual_seed(31)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, MOE_TP_SEQ),
                                     generator=g, dtype=torch.int32).to(dev)}
    full = M.init_params(cfg, seed=0, device=dev)
    with torch.no_grad(), MO.recording_routes() as ref_routes:
        ref_logits = M.forward(full, cfg, batch)[0]
    shard = MX.shard_params(full, cfg, rank, size)
    del full
    torch.cuda.empty_cache()
    tcfg = moe_config(n_layers=2, remat=True, dtype="float32")
    if rank == 0:
        _, hist = trainer.train(tcfg, steps=1, batch=1, seq_len=MOE_TP_SEQ,
                                log_every=1, device=dev)
        out["one_device_train"] = [(h["loss"], h["grad_norm"], h["aux"])
                                   for h in hist]
        torch.cuda.empty_cache()
    dist.barrier()

    def part(name, fn):
        ops.reset_launches()
        ops.reset_dispatch_paths()
        tp.reset_collectives()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        out[name] = dict(res or {}, ms=(time.perf_counter() - t0) * 1e3,
                         counts=tp.collective_counts(),
                         launches=nonzero(ops.launch_counts()),
                         paths=ops.dispatch_paths())

    def forward():
        with torch.no_grad(), MO.recording_routes() as routes:
            logits = M.forward(shard, cfg, batch, plan)[0]
        flips = route_flips(routes, f"rank {rank}, TP forward",
                            ref=ref_routes, what="TP vs one device")
        first = min([r for _, r, _ in flips], default=MOE_TP_SEQ)
        return {"logit_err": max_err(logits[:, :first],
                                     ref_logits[:, :first]),
                "logit_top": ref_logits.float().abs().max().item(),
                "logit_sum": logits.float().sum().item(),
                "gated": first}
    part("forward", forward)
    del ref_logits, shard, ref_routes
    torch.cuda.empty_cache()

    def train():
        torch.cuda.reset_peak_memory_stats(dev)
        _, hist = trainer.train(tcfg, steps=1, batch=1, seq_len=MOE_TP_SEQ,
                                log_every=1, plan=plan, device=dev)
        return {"hist": [(h["loss"], h["grad_norm"], h["aux"])
                         for h in hist],
                "peak": torch.cuda.max_memory_allocated(dev)}
    part("train", train)
    torch.cuda.empty_cache()

    refs = torch.load(oracle_path)
    for name, (arch, path, t_rank) in MOE_EP_CASES.items():
        ecfg = ep_config(arch)
        n_loc = ecfg.n_experts // size
        p = ep_weights(ecfg, rank * n_loc, (rank + 1) * n_loc, dev)
        x, dy = ep_inputs(ecfg, size * t_rank, dev)
        sl = slice(rank * t_rank, (rank + 1) * t_rank)
        x = x[:, sl].clone().requires_grad_(True)
        fn = {"sharded": MO.moe_apply_sharded,
              "shard_slot": MO.moe_apply_shard_slot}[path]
        res = {}

        def fwd():
            with MO.recording_routes() as routes:
                res["y"], res["aux"] = fn(p, ecfg, x, group)
            res["routes"] = routes

        def bwd():
            res["y"].backward(dy[:, sl])
        part(f"ep {name} forward", fwd)
        part(f"ep {name} backward", bwd)
        y_ref, dx_ref, e_ref, p_ref = refs[name]
        y_ref, dx_ref = y_ref[:, sl], dx_ref[:, sl]
        # a token is its own row here (no attention): a token routed
        # otherwise at a near tie is left out of the gates
        flips = route_flips(res["routes"], f"rank {rank}, {name}",
                            ref=[(e_ref[sl], p_ref[sl])],
                            eps=MOE_GAP_EPS[torch.bfloat16],
                            what="vs one device")
        kept = torch.ones(t_rank, dtype=torch.bool)
        kept[[r for _, r, _ in flips]] = False
        out[name] = {"err": max_err(res["y"].cpu()[:, kept], y_ref[:, kept]),
                     "ulp": bf16_ulp(y_ref),
                     "grad_err": max_err(x.grad.cpu()[:, kept],
                                         dx_ref[:, kept]),
                     "grad_top": dx_ref.float().abs().max().item(),
                     "finite": bool(torch.isfinite(res["y"]).all()
                                    and torch.isfinite(x.grad).all()),
                     "experts": n_loc, "tokens": t_rank,
                     "flipped": len(flips)}
        del p, x, res
        torch.cuda.empty_cache()
    return out


def moe_dist_phase(smi):
    """Explicit TP and expert parallelism of the MoE family over two gloo
    ranks on this card (``moe_rank``); the EP oracle first, on one device
    in this process.  Returns rank 0's launches on the TP paths."""
    import tempfile
    from repro_torch.core import tp
    phase(f"MoE expert parallelism: the one-device oracle ({', '.join(MOE_EP_CASES)})")
    with tempfile.TemporaryDirectory(prefix="moe_ep_") as tmp:
        oracle = os.path.join(tmp, "oracle.pt")
        ep_oracle(oracle)
        phase(f"MoE tensor and expert parallelism: gloo, world size "
              f"{TP_SIZE}, {MOE_ARCH} full width, 2 layers, fp32, "
              f"S={MOE_TP_SEQ}, {128 // TP_SIZE} experts a rank; card {smi}")
        t0 = time.perf_counter()
        ranks = tp.run_ranks("chip_smoke:moe_rank", TP_SIZE, backend="gloo",
                             args=(oracle,), timeout=900)
    print(f"  {TP_SIZE} ranks done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return moe_dist_report(ranks, smi)


def moe_dist_report(ranks, smi):
    """Print and gate ``moe_rank``'s results."""
    L = 2
    one = ranks[0]["one_device_train"]
    for r in ranks:
        f, t = r["forward"], r["train"]
        print(f"  rank {r['rank']}: fp32 forward logits vs one device over "
              f"the first {f['gated']} positions: max |diff| "
              f"{f['logit_err']:.3e} (max |logit| {f['logit_top']:.3f}; tol "
              f"{MOE_TP_LOGIT_TOL}); all-reduces "
              f"{_ar(f['counts'])} (want fal's L + 1 = {L + 1}), all-to-alls "
              f"{_ar(f['counts'], kind='all-to-all')}; {f['ms']:.1f} ms; "
              f"launches {f['launches']}", flush=True)
        require(f["logit_err"] <= MOE_TP_LOGIT_TOL, "MoE TP logits "
                "disagree with the one-device forward")
        require(_ar(f["counts"]) == L + 1
                and _ar(f["counts"], kind="all-to-all") == 0,
                "MoE TP forward collectives")
        print(f"  rank {r['rank']}: one trainer step (fal, fp32, remat) TP "
              f"(loss, grad_norm, aux) "
              f"{[tuple(round(v, 6) for v in h) for h in t['hist']]}, one "
              f"device {[tuple(round(v, 6) for v in h) for h in one]} (tol "
              f"{MOE_TP_LOSS_TOL} / relative {MOE_TP_GNORM_RTOL}); "
              f"{t['ms']:.1f} ms "
              f"with init over gloo through host memory; peak "
              f"{t['peak'] / 2**30:.2f} GiB; all-reduces forward "
              f"{_ar(t['counts'])}, backward {_ar(t['counts'], 'backward')}, "
              f"step {_ar(t['counts'], 'step')}; launches {t['launches']}; "
              f"card {smi}", flush=True)
        for (la, ga, xa), (lb, gb, xb) in zip(t["hist"], one):
            require(abs(la - lb) <= MOE_TP_LOSS_TOL
                    and abs(xa - xb) <= MOE_TP_LOSS_TOL
                    and abs(ga - gb) <= MOE_TP_GNORM_RTOL * gb,
                    "MoE TP training disagrees with one device")
        for name, (arch, path, t_rank) in MOE_EP_CASES.items():
            e = r[name]
            fw, bw = r[f"ep {name} forward"], r[f"ep {name} backward"]
            a2a = {d: (_ar(c, d, kind="all-to-all"),
                       _ar(c, d, "bytes", kind="all-to-all"))
                   for c, d in ((fw["counts"], "forward"),
                                (bw["counts"], "backward"))}
            print(f"  rank {r['rank']}: {name}: {e['experts']} experts and "
                  f"{e['tokens']} tokens a rank ({e['flipped']} routed "
                  f"otherwise at a near tie, left out); output vs one-device "
                  f"moe_apply max |diff| {e['err']:.4e} (tol {MOE_EP_ULPS} "
                  f"bf16 ulps = {MOE_EP_ULPS * e['ulp']:.4e}); input "
                  f"gradient max |diff| {e['grad_err']:.4e} (max "
                  f"{e['grad_top']:.4f}, tol {MOE_EP_GRAD_RTOL} of it); "
                  f"all-to-alls (calls, bytes) forward {a2a['forward']}, "
                  f"backward {a2a['backward']}; all-reduces forward "
                  f"{_ar(fw['counts'])}, backward "
                  f"{_ar(bw['counts'], 'backward')}; forward "
                  f"{fw['ms']:.1f} ms, backward {bw['ms']:.1f} ms (gloo "
                  f"through host memory)", flush=True)
            want = (2, 2) if path == "sharded" else (4, 3)
            require(e["finite"] and e["err"] <= MOE_EP_ULPS * e["ulp"]
                    and e["grad_err"] <= MOE_EP_GRAD_RTOL * e["grad_top"],
                    f"{name} disagrees with moe_apply on one device")
            require((a2a["forward"][0], a2a["backward"][0]) == want,
                    f"{name}: all-to-all calls {a2a} != {want}")
    require(len({r["forward"]["logit_sum"] for r in ranks}) == 1,
            "MoE TP logits differ across ranks")
    from repro_torch.kernels import ops
    for r in ranks:
        require(r["forward"]["paths"] == {"flash_attention": ops.CUDA,
                                          "fused_ln_add": ops.CUDA},
                f"MoE TP forward paths {r['forward']['paths']}")
    return ranks[0]["forward"]["launches"], ranks[0]["train"]["launches"]


# --------------------------------------------------------------------------- #
# phase 16: MLA and the MTP head (deepseek-v3-671b), the VLM's image prefix
# (llava-next-mistral-7b)
# --------------------------------------------------------------------------- #
MLA_ARCH = "deepseek-v3-671b"
VLM_ARCH = "llava-next-mistral-7b"
#: deepseek-v3 at full width: 2 layers (both dense: first_dense_layers is
#: 3) and the MTP head for the fp32 card-vs-CPU ticks and training; 4
#: layers (block 0, two dense, one MoE; 15.8 B parameters, 31.6 GB in
#: bf16) for the engine
MLA_TICK_LAYERS, MLA_ENGINE_LAYERS, MLA_TRAIN_LAYERS = 2, 4, 2
MLA_CHUNK_LANES = ((0, 64), (64, 64), (200, 37), (300, 0))
MLA_CONTIG_TICKS = 4
#: the card-vs-CPU loss and gradient: B=1 x MLA_GRAD_SEQ tokens (the CPU
#: runs 3.7 B fp32 parameters forward and backward)
MLA_GRAD_SEQ = 32
#: the engine: a shared 256-token system prompt (16 pages) with suffixes,
#: in two waves (the second hits the first's parked prefixes: a verbatim
#: repeat of a page-aligned prompt enters decode with one COW copy)
MLA_ENGINE_NEW = 24
MLA_TRAIN_STEPS, MLA_TRAIN_S = 4, 1024
#: TP (inside the gloo TP phase): deepseek-v3 full width, 2 layers, fp32
MLA_TP_LAYERS, MLA_TP_SEQ = 2, 512
#: llava at full depth: the 2,880-token image prefix plus text, prefilled
#: in packed ticks of VLM_CHUNK tokens, then VLM_DECODE decode ticks
VLM_TEXT, VLM_CHUNK, VLM_DECODE = 128, 512, 16


def mla_config(**kw):
    from repro_torch.configs.base import get_config
    return get_config(MLA_ARCH).replace(**kw)


def vlm_config(**kw):
    from repro_torch.configs.base import get_config
    return get_config(VLM_ARCH).replace(**kw)


def _n_params(params):
    from repro_torch.optim import adamw
    return sum(t.numel() for _, t in adamw.named_leaves(params))


def mla_tick_phase():
    """deepseek-v3 at full width, MLA_TICK_LAYERS layers plus the MTP head,
    fp32 (3.71 B parameters): a packed tick, a padded chunk tick, a C == 1
    tick under the dual-branch plan (MLA blocks take the unfused route), 4
    contiguous decode ticks and one training pass's loss (ce, aux, mtp)
    and gradient norm, each on the card against the CPU.  MLA's serving
    paths are PyTorch ops (no paged kernel reads latents): a tick launches
    ``fused_ln_add`` only."""
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = mla_config(n_layers=MLA_TICK_LAYERS, dtype="float32")
    L, cuda = cfg.n_layers, ops.CUDA
    phase(f"{MLA_ARCH} ticks at full width, {L} layers + MTP, fp32: card "
          f"vs CPU")
    t0 = time.perf_counter()
    params = interop.tree_to(M.init_params(cfg, seed=0, device="cuda",
                                           dtype="float32"), "cpu")
    torch.cuda.empty_cache()
    print(f"  {_n_params(params) / 1e9:.3f} B parameters; init_params on "
          f"the card, copied to the CPU: {time.perf_counter() - t0:.1f} s",
          flush=True)
    ln = {"fused_ln_add": cuda}
    counts = packed_tick(cfg, params, want_paths=ln, scaled_tol=True)
    require(counts["fused_ln_add"] == L and sum(counts.values()) == L,
            f"MLA packed tick launches {nonzero(counts)}")
    padded_tick(cfg, params, "deepseek-v3 chunk tick C=64", 64,
                MLA_CHUNK_LANES, 24, False, ln, scaled_tol=True)
    counts = padded_tick(cfg, params, "deepseek-v3 dual-branch decode tick "
                         "C=1", 1, MOE_DECODE_LANES, 64, True, ln,
                         scaled_tol=True)
    require(counts["fused_dual_branch_decode"] == 0
            and counts["fused_ln_add"] == L,
            f"MLA dual C == 1 tick launches {nonzero(counts)}: MLA blocks "
            f"take the unfused route")
    contiguous_card_vs_cpu(cfg, params, f"{MLA_ARCH} full width, {L} "
                           f"layers, fp32", CONTIG_LANES, CONTIG_S,
                           MLA_CONTIG_TICKS, scaled_tol=True)
    mla_loss_tick(cfg, params)
    del params
    print(f"  MLA tick phases: {time.perf_counter() - t0:.1f} s", flush=True)


def mla_loss_tick(cfg, params):
    """``loss_fn`` and its backward on B=1 x MLA_GRAD_SEQ tokens, on the
    card (kernels) and on the CPU (plain versions) from the same weights:
    loss, ce, aux, mtp and the gradient norm within 1e-4 (fp32 sums in
    another order)."""
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    S = MLA_GRAD_SEQ
    phase(f"{MLA_ARCH}: loss (ce, aux, mtp) and gradient norm, {cfg.n_layers}"
          f" layers + MTP, fp32, B=1, S={S}: card vs CPU")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=g,
                           dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        p = interop.tree_to(params, dev) if dev == "cuda" else adamw.map_tree(
            lambda t: t.detach(), params)
        for _, t in adamw.named_leaves(p):
            t.requires_grad_(True)
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t0 = time.perf_counter()
        loss, m = M.loss_fn(p, cfg, {"tokens": tokens.to(dev)})
        loss.backward()
        norm = math.sqrt(sum(float(t.grad.double().square().sum())
                             for _, t in adamw.named_leaves(p)))
        out[dev] = dict({k: float(v.detach()) for k, v in m.items()},
                        loss=float(loss.detach()), norm=norm,
                        secs=time.perf_counter() - t0,
                        counts=ops.launch_counts(), paths=ops.dispatch_paths())
        del p, loss, m
        torch.cuda.empty_cache()
    c, h = out["cuda"], out["cpu"]
    diffs = {k: abs(c[k] - h[k]) for k in ("loss", "ce", "aux", "mtp")}
    d_norm = abs(c["norm"] - h["norm"]) / h["norm"]
    print(f"  card {({k: round(c[k], 6) for k in diffs})} CPU "
          f"{({k: round(h[k], 6) for k in diffs})}; |diff| "
          f"{({k: f'{v:.2e}' for k, v in diffs.items()})} (tol 1e-4); grad "
          f"norm {c['norm']:.6f} / {h['norm']:.6f}, relative diff "
          f"{d_norm:.3e} (tol 1e-4); card {c['secs']:.1f} s, CPU "
          f"{h['secs']:.1f} s; card paths {c['paths']}; launches "
          f"{nonzero(c['counts'])}", flush=True)
    require(all(v <= 1e-4 for v in diffs.values()) and d_norm <= 1e-4,
            "the card's MLA loss or gradient disagrees with the CPU")
    require(c["paths"] == {"flash_attention": ops.CUDA,
                           "fused_ln_add": ops.CUDA},
            f"MLA training paths {c['paths']}")
    require(all(math.isfinite(c[k]) for k in diffs) and c["mtp"] > 0,
            "non-finite or missing MTP loss")


def mla_engine_phase():
    """deepseek-v3 at full width, MLA_ENGINE_LAYERS layers (block 0, two
    dense, one MoE), bf16, through ``PagedEngine`` with the prefix cache:
    a first wave of 6 greedy requests over a shared 256-token system
    prompt, then a second wave of 2 (a verbatim repeat of a page-aligned
    prompt, which enters decode from the cache with one COW copy, and a
    new suffix), the counters zeroed before each wave and read after it;
    then one prefill tick under torch.profiler.  A tick launches
    ``fused_ln_add`` once a layer; a COW launches ``page_copy`` once over
    both latent pools of every layer."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import (EngineConfig, PagedEngine,
                                             ServeRequest)
    cfg = mla_config(n_layers=MLA_ENGINE_LAYERS)
    L, new = cfg.n_layers, MLA_ENGINE_NEW
    kinds = "/".join(M.layer_kinds(cfg))
    phase(f"engine: {MLA_ARCH}, {L} layers ({kinds}), bf16, prefix cache, "
          f"8 greedy requests + {new}")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"  init_params on the card: {time.perf_counter() - t0:.1f} s; "
          f"{_n_params(params) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    ecfg = EngineConfig(page_size=16, num_pages=1024, slots=8,
                        prefill_chunk=256, max_seq=2048,
                        cache_dtype="bfloat16", prefix_cache=True)
    engine = PagedEngine(cfg, params, ecfg)
    rng = np.random.default_rng(29)
    sysp = rng.integers(0, cfg.vocab, 256)
    first = [np.concatenate([sysp, rng.integers(0, cfg.vocab, n)])
             for n in (0, 16, 40, 75, 130, 200)]
    second = [first[0].copy(), np.concatenate(
        [sysp, rng.integers(0, cfg.vocab, 60)])]
    engine.submit(ServeRequest(rid=-1, prompt=rng.integers(0, cfg.vocab, 32),
                               max_new=4))
    engine.run()                                     # warm-up
    engine.pcache.clear()
    waves, total = [], {"gen": 0, "wall": 0.0, "ticks": 0}
    counts_all = {}
    for w, prompts in enumerate((first, second)):
        engine.finished.clear()
        engine.reset_stats()
        for i, p in enumerate(prompts):
            engine.submit(ServeRequest(rid=10 * w + i, prompt=p, max_new=new))
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts, paths, st = (ops.launch_counts(), ops.dispatch_paths(),
                             engine.stats())
        gen = sum(len(r.generated) for r in done)
        pre = st["prefix"]
        print(f"  wave {w + 1}: {len(done)} requests, ticks {st['ticks']}, "
              f"{gen} tokens in {wall:.2f} s = {gen / wall:.1f} tok/s; "
              f"engine_dispatch_ms p50 {st['dispatch_ms']['p50']:.2f} p99 "
              f"{st['dispatch_ms']['p99']:.2f}; ttft_ms p50 "
              f"{st['ttft_ms']['p50']:.1f}; prefix hits {pre['hits']}, COW "
              f"copies {pre['cow_copies']}; page_bytes "
              f"{engine.allocator.page_bytes}; launches {nonzero(counts)} "
              f"(ticks x layers = {st['ticks'] * L}); paths {paths}",
              flush=True)
        require(len(done) == len(prompts)
                and all(len(r.generated) == new for r in done),
                f"not every MLA request finished with {new} tokens")
        require(counts["fused_ln_add"] == st["ticks"] * L
                and counts["page_copy"] == pre["cow_copies"]
                and sum(counts.values()) == st["ticks"] * L
                + pre["cow_copies"],
                f"MLA engine launches {nonzero(counts)} != ticks x layers "
                f"+ COW copies")
        waves.append(dict(ticks=st["ticks"], p50=st["dispatch_ms"]["p50"],
                          p99=st["dispatch_ms"]["p99"], hits=pre["hits"],
                          cow=pre["cow_copies"], tok_s=gen / wall))
        total["gen"] += gen
        total["wall"] += wall
        total["ticks"] += st["ticks"]
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
    require(waves[1]["hits"] >= 2 and waves[1]["cow"] >= 1,
            f"the second wave did not hit the cache with a COW: {waves[1]}")
    # one prefill tick under the profiler
    engine.finished.clear()
    engine.reset_stats()
    for i, p in enumerate(first):
        engine.submit(ServeRequest(rid=100 + i, prompt=p[::-1].copy(),
                                   max_new=new))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.run(max_ticks=1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    device = busy_ms(prof)
    out = dict(tok_s=total["gen"] / total["wall"], ticks=total["ticks"],
               p50=waves[0]["p50"], p99=waves[0]["p99"],
               ln_launches=counts_all["fused_ln_add"],
               copy_launches=counts_all["page_copy"],
               n_params=_n_params(params))
    if device == 0.0:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels)")
    else:
        out.update(device_ms=device, busy=device / wall)
        print(f"  one prefill tick profiled: device time {device:.2f} ms "
              f"busy, wall {wall:.2f} ms, busy share {device / wall:.3f}",
              flush=True)
    del engine, params
    torch.cuda.empty_cache()
    return out


def mla_train_phase():
    """``trainer.train`` at deepseek-v3's full width, MLA_TRAIN_LAYERS
    layers plus the MTP head (3.71 B parameters: 59.3 GB of fp32 masters,
    gradients and moments), fal, bf16 compute, remat, B=1,
    S=MLA_TRAIN_S: one warm-up step and MLA_TRAIN_STEPS - 1 counted, then
    one step under torch.profiler.  Every full-sequence attention (both
    layers and the MTP block) runs the D = 192 flash kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train import trainer
    cfg = mla_config(n_layers=MLA_TRAIN_LAYERS)
    steps, B, S, L = MLA_TRAIN_STEPS, 1, MLA_TRAIN_S, cfg.n_layers
    phase(f"train: {MLA_ARCH}, {L} layers + MTP, {cfg.connection}, fp32 "
          f"masters, {cfg.dtype} compute, remat {cfg.remat}, B={B}, S={S}, "
          f"{steps - 1} steps after 1 warm-up")
    marks = []

    def mark(i, state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if i == 0:
            ops.reset_launches()
            ops.reset_dispatch_paths()
            torch.cuda.reset_peak_memory_stats()

    state, hist = trainer.train(cfg, steps=steps, batch=B, seq_len=S,
                                log_every=1, device="cuda", callbacks=[mark])
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    peak = torch.cuda.max_memory_allocated()
    n_par = _n_params(state["params"])
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms)
    flash = {k: counts[k] for k in ("flash_attention", "flash_attention.bwd",
                                    "fused_ln_add", "fused_ln_add.bwd")}
    print(f"  {n_par / 1e9:.3f} B parameters; (loss, ce, mtp) "
          f"{[(round(h['loss'], 4), round(h['ce'], 4), round(h['mtp'], 4)) for h in hist]}; "
          f"step ms {['%.1f' % x for x in step_ms]} (median {ms:.1f}); "
          f"{B * S / ms * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated, counted steps); "
          f"launches {flash} in {steps - 1} steps; paths {paths}",
          flush=True)
    require(all(math.isfinite(h[k]) for h in hist
                for k in ("loss", "ce", "mtp")),
            "MLA train: a non-finite loss, ce or mtp")
    n = steps - 1
    # remat: each of the L blocks and the MTP block run their forward
    # twice; fal's LN-add runs in the L main blocks only (the MTP block is
    # preln)
    want = {"flash_attention": 2 * n * (L + 1), "flash_attention.bwd":
            n * (L + 1), "fused_ln_add": 2 * n * L, "fused_ln_add.bwd": n * L}
    require(flash == want, f"MLA train launches {flash} != {want}")
    require(paths == {"flash_attention": ops.CUDA, "fused_ln_add": ops.CUDA},
            f"MLA train paths {paths}")
    step = tstep.make_train_step(cfg, adamw.AdamWConfig(lr=3e-4))
    g = torch.Generator().manual_seed(31)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32).cuda()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device_ms = busy_ms(prof)
    out = dict(step_ms=ms, tok_s=B * S / ms * 1e3, peak=peak, n_params=n_par)
    if device_ms == 0.0:
        print("  device time: not measured (the profiler saw no CUDA "
              "kernels)")
    else:
        out.update(device_ms=device_ms, busy=device_ms / wall)
        print(f"  profiled step: wall {wall:.1f} ms, device time "
              f"{device_ms:.1f} ms busy, busy share {device_ms / wall:.3f}",
              flush=True)
    del state
    torch.cuda.empty_cache()
    return flash, out


def vlm_phase():
    """llava-next-mistral-7b: at 2 layers in fp32 a packed tick and a
    padded chunk tick with every row's patch embedding, card vs CPU; then
    at full depth (32 layers, bf16, 7.24 B parameters) the 2,880-token
    image prefix plus VLM_TEXT text tokens prefilled through packed ticks
    of VLM_CHUNK tokens with ``image_embeds``, then VLM_DECODE decode
    ticks, the counters zeroed before and read after; the prefill's
    logits beside the full-sequence forward's; ``PagedEngine`` refuses
    the image config."""
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import EngineConfig, PagedEngine
    cuda = ops.CUDA
    cfg = vlm_config(n_layers=2, dtype="float32")
    phase(f"{VLM_ARCH} at full width, 2 layers, fp32, image prefix rows: "
          f"card vs CPU")
    t0 = time.perf_counter()
    params = interop.tree_to(M.init_params(cfg, seed=0, device="cuda",
                                           dtype="float32"), "cpu")
    torch.cuda.empty_cache()
    packed_tick(cfg, params, scaled_tol=True, image=True)
    padded_tick(cfg, params, "llava chunk tick C=64 with patch embeddings",
                64, MLA_CHUNK_LANES, 24, False,
                {"paged_chunk_attention": cuda, "fused_ln_add": cuda},
                scaled_tol=True, image=True)
    del params
    cfg = vlm_config()
    L, n_img = cfg.n_layers, cfg.n_image_tokens
    S = n_img + VLM_TEXT
    phase(f"{VLM_ARCH} at full depth ({L} layers), bf16: {n_img} image + "
          f"{VLM_TEXT} text tokens in packed ticks of {VLM_CHUNK}, then "
          f"{VLM_DECODE} decode ticks")
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    try:
        PagedEngine(cfg, params, EngineConfig())
        raise AssertionError("PagedEngine took a config with an image prefix")
    except NotImplementedError as e:
        print(f"  PagedEngine refuses the image config: {e}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(37)
    tokens = torch.randint(0, cfg.vocab, (1, S + VLM_DECODE), generator=g,
                           device="cuda", dtype=torch.int32)
    img = (torch.randn((1, n_img, cfg.d_model), generator=g, device="cuda")
           * 0.02).to(torch.bfloat16)
    tb = (S + VLM_DECODE) // PAGE + 1
    cache = M.init_paged_cache(cfg, tb + 2, PAGE, 1, "bfloat16")
    bt = torch.arange(1, tb + 1, dtype=torch.int32, device="cuda")[None]
    zeros = torch.zeros((1, cfg.d_model), dtype=torch.bfloat16, device="cuda")

    def tick(lo, hi):
        pos = torch.arange(lo, hi, dtype=torch.int32, device="cuda")
        rows = torch.cat([img[0], zeros.expand(S + VLM_DECODE - n_img, -1)])
        batch = dict(tokens=tokens[0, lo:hi], tok_slot=torch.zeros_like(pos),
                     tok_pos=pos, block_tables=bt,
                     seg_last=torch.tensor([hi - lo - 1], dtype=torch.int32,
                                           device="cuda"),
                     image_embeds=rows[lo:hi])
        with torch.no_grad():
            return M.paged_decode_step(params, cfg, batch, cache)[0]
    torch.cuda.synchronize()
    ops.reset_launches()
    ops.reset_dispatch_paths()
    t = time.perf_counter()
    pre = [tick(lo, min(lo + VLM_CHUNK, S)) for lo in range(0, S, VLM_CHUNK)]
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t
    t = time.perf_counter()
    dec = [tick(i, i + 1) for i in range(S, S + VLM_DECODE)]
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t) * 1e3 / VLM_DECODE
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    n_ticks = len(pre) + len(dec)
    logits = torch.cat([x[0] for x in pre + dec]).float()
    with torch.no_grad():
        full = M.forward(params, cfg, {"tokens": tokens,
                                       "image_embeds": img})[0][0].float()
    diff = (logits - full).abs().max().item()
    agree = (logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"  {_n_params(params) / 1e9:.3f} B parameters; prefill "
          f"{len(pre)} packed ticks in {pre_s:.2f} s ({S / pre_s:.0f} tok/s)"
          f"; decode {dec_ms:.2f} ms a tick; logits of every position vs "
          f"the full-sequence forward: max |diff| {diff:.4f}, argmax "
          f"agreement {agree:.3f}; launches {nonzero(counts)} ({n_ticks} "
          f"ticks x {L} layers = {n_ticks * L}); paths {paths}", flush=True)
    require(logits.shape == full.shape and bool(torch.isfinite(logits).all()),
            "llava's ticks gave non-finite logits or the wrong shape")
    require(counts["paged_packed_attention"] == n_ticks * L
            and counts["fused_ln_add"] == n_ticks * L,
            f"llava tick launches {nonzero(counts)} != ticks x layers")
    del params, cache
    torch.cuda.empty_cache()
    print(f"  VLM phases: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(prefill_tok_s=S / pre_s, decode_ms=dec_ms, diff=diff,
                agree=agree, launches=counts["paged_packed_attention"],
                ln_launches=counts["fused_ln_add"])


# --------------------------------------------------------------------------- #
# phase 17: the SSM, hybrid and audio families
# --------------------------------------------------------------------------- #
SSM_ARCH, HYBRID_ARCH, AUDIO_ARCH = ("mamba2-370m", "zamba2-1.2b",
                                     "whisper-small")
FAMILIES = (SSM_ARCH, HYBRID_ARCH, AUDIO_ARCH)
#: (a) card vs CPU in fp32 at full width: each family's depth cut, batch
#: and sequence.  mamba: S = 512, two SSD chunks, so the inter-chunk loop
#: runs; zamba: 13 layers, two groups of 6 and a trailing layer, so group
#: 0, a later group and the tail all run, at one chunk (its CPU side's
#: fp32 GEMMs set this phase's time); whisper: 2 + 2 layers over its
#: 1,500 frames.  One row each and zamba at S = 128 since the families' TP
#: part joined phase 13a (mamba and whisper B = 2, zamba S = 256 before)
FAMILY_TICKS = {SSM_ARCH: (dict(n_layers=2), 1, 512),
                HYBRID_ARCH: (dict(n_layers=13), 1, 128),
                AUDIO_ARCH: (dict(n_layers=2, n_enc_layers=2), 1, 64)}
FAMILY_DECODE_TICKS = 16
#: card vs CPU bounds (fp32 sums in other orders, TF32 off): logits within
#: TICK_TOLS[""] x max(1, the largest |logit|); loss 1e-4 and the gradient
#: norm 1e-4 relative, as train_tick's
FAMILY_LOSS_TOL, FAMILY_GNORM_RTOL = 1e-4, 1e-4
#: (b) serving in bf16 at full depth: the batcher's slots, requests and each
#: request's prompt and new tokens (16 requests through 8 slots: every
#: slot is taken twice, so the recurrent-state reset runs; 16 + 16 tokens
#: since the families' TP part joined phase 13a, 32 + 32 since the
#: sequence-cut decode check joined phase 13b, 64 + 64 before: each time
#: the host-bound ticks halve); decode == forward over FAMILY_FWD_B lanes
#: of FAMILY_FWD_S tokens (32 since that TP part, 64 before)
FAMILY_SLOTS, FAMILY_REQS, FAMILY_PROMPT, FAMILY_NEW = 8, 16, 16, 16
FAMILY_FWD_B, FAMILY_FWD_S = 4, 32
#: bound on |logit| differences between decode_step and forward in bf16 at
#: full depth, over every logit.  The two compute the same function in
#: other orders with other bf16 rounding points: mamba's chunked SSD
#: (products of bf16-rounded decays and scores, fp32 sums) against the
#: recurrence's fp32 state update; zamba's and whisper's attention through
#: the flash kernel against decode's fp32 scores; every layer rounds its
#: output to bf16 (relative 2^-9), over 48 (mamba), 38 + 6 (zamba) and
#: 12 + 12 (whisper) layers, and the logits are bf16 themselves (one ulp is
#: 2^-5 at |logit| >= 4): CONTIG_FWD_BOUND's reasoning at up to twice the
#: depth
FAMILY_FWD_BOUND = 0.5
WHISPER_SERVE_B, WHISPER_NEW = 8, 64
#: (c) training at full depth: (batch, sequence).  SSD's largest tensor is
#: the (B, S / 256, H, 256, 256) decay matrix, 0.27 GB in fp32 for mamba2
#: (H = 32) at B = 4 and for zamba2 (H = 64) at B = 2 at S = 2048 (B = 8
#: and 4 at S = 2048 until the families' TP part joined phase 13a, S = 1024
#: since); whisper's sequence is the decoder's (its encoder reads 1,500
#: frames)
FAMILY_TRAIN = {SSM_ARCH: (4, 1024), HYBRID_ARCH: (2, 1024),
                AUDIO_ARCH: (8, 448)}
FAMILY_TRAIN_STEPS = 3


#: tensor parallelism of the three families (phase 13a, inside tp_rank's
#: two-rank spawn): each at full width in fp32, remat off, cut in depth
#: (whisper 2 + 2 layers over its 1,500 frames; zamba2 13 layers: two
#: groups of 6, so invocation 0's export, a later fused invocation and the
#: tail all run; mamba2 2 layers), (config cut, B, S); every rank checks
#: its forward logits and one train step against the one-device run of the
#: same seed on its card, TP_FAMILY_TICKS greedy decode ticks' tokens, the
#: all-reduce counts and the kernels' launches
TP_FAMILY = {AUDIO_ARCH: (dict(n_layers=2, n_enc_layers=2), 1, 64),
             HYBRID_ARCH: (dict(n_layers=13), 1, 128),
             SSM_ARCH: (dict(n_layers=2), 1, 256)}
TP_FAMILY_TICKS = 16


def tp_family_config(arch):
    return family_config(arch, dtype="float32", remat=False,
                         **TP_FAMILY[arch][0])


def tp_family_inputs(arch, dev):
    """(cfg, full fp32 params from seed 0 on ``dev``, batch)."""
    from repro_torch.models import model as M
    cfg = tp_family_config(arch)
    _, B, S = TP_FAMILY[arch]
    params = M.init_params(cfg, seed=0, device=dev, dtype="float32")
    batch = family_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(
        43), dev)
    return cfg, params, batch


def tp_family_decode(cfg, params, batch, plan=None):
    """TP_FAMILY_TICKS greedy ``make_serve_step`` ticks from each lane's
    first token at position 0 (whisper: ``enc_out`` from
    ``whisper_encode`` first) -> tokens (B, ticks) on the host."""
    from repro_torch.models import model as M
    from repro_torch.serve.decode import make_serve_step
    tokens = batch["tokens"]
    B, dev = tokens.shape[0], tokens.device
    size = 1 if plan is None else plan.tp_size
    cache = M.init_cache(cfg, B, TP_FAMILY_TICKS + 1, "float32", device=dev,
                         tp_size=size)
    if cfg.family == "audio":
        with torch.no_grad():
            cache["enc_out"].copy_(M.whisper_encode(params, cfg,
                                                    batch["frames"], plan))
    step = make_serve_step(cfg, plan)
    tok, out = tokens[:, :1], []
    for t in range(TP_FAMILY_TICKS):
        nxt, _, cache = step(params, cache, tok, torch.full(
            (B,), t, dtype=torch.int32, device=dev))
        tok = nxt[:, None]
        out.append(nxt)
    return torch.stack(out, 1).cpu()


def tp_family_step(cfg, params, batch, plan=None):
    """One AdamW step (``make_train_step``) -> (state, loss, grad norm)."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    ocfg = adamw.AdamWConfig(lr=3e-4)
    state = tstep.init_state(0, cfg, ocfg, params=params)
    state, m = tstep.make_train_step(cfg, ocfg, plan)(state, batch)
    return state, float(m["loss"]), float(m["grad_norm"])


def tp_family_refs(dev, rank, size):
    """The one-device side on this rank's card: each family's logits, its
    greedy tokens, and after one train step its loss, grad norm and this
    rank's shard of the updated params."""
    from repro_torch.launch import mesh as MX
    from repro_torch.models import model as M
    refs = {}
    for arch in TP_FAMILY:
        cfg, params, batch = tp_family_inputs(arch, dev)
        with torch.no_grad():
            logits = M.forward(params, cfg, batch)[0]
        tokens = tp_family_decode(cfg, params, batch)
        state, loss, gnorm = tp_family_step(cfg, params, batch)
        refs[arch] = {"logits": logits, "tokens": tokens, "loss": loss,
                      "grad_norm": gnorm, "params": MX.shard_params(
                          state["params"], cfg, rank, size)}
        del params, state
        torch.cuda.empty_cache()
    return refs


def tp_family_expected(cfg):
    """{part: (forward all-reduces, backward ones, the kernels' launches)}
    of the family's TP parts (remat off): whisper's encoder blocks take the
    decoders' paths (fal: L_enc + 1) and each decoder block assembles its
    self-attention, its cross-attention and its FFN (3 L_dec), plus one *f*
    on the encoder's output in the backward; zamba2's shared block pays
    n_groups + 1 under fal (invocation 0's attention and FFN, each later
    invocation one); mamba2 none.  Launches: whisper a flash call per
    encoder block and two per decoder block (self, cross; at decode the
    cross one), an LN-add per block (fal); zamba2 one of each per
    invocation; at decode the encoder once and every tick's share."""
    n = TP_FAMILY_TICKS
    if cfg.family == "ssm":
        return {"forward": (0, 0, {}), "train": (0, 0, {}),
                "decode": (0, 0, {})}
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        ar, fa, ln, tick_ar, tick_fa, tick_ln = g + 1, g, g, g + 1, 0, g
        enc_ar = enc_fa = enc_ln = back = 0
    else:
        ar = cfg.n_enc_layers + 1 + 3 * cfg.n_layers
        fa = cfg.n_enc_layers + 2 * cfg.n_layers
        ln = cfg.n_enc_layers + cfg.n_layers
        tick_ar, tick_fa, tick_ln = 3 * cfg.n_layers, cfg.n_layers, \
            cfg.n_layers
        enc_ar, enc_fa, enc_ln, back = cfg.n_enc_layers + 1, \
            cfg.n_enc_layers, cfg.n_enc_layers, 1
    parts = {"forward": (ar, 0, {"flash_attention": fa,
                                 "fused_ln_add": ln}),
             "train": (ar, ar + back, {
                 "flash_attention": fa, "flash_attention.bwd": fa,
                 "fused_ln_add": ln, "fused_ln_add.bwd": ln}),
             "decode": (enc_ar + n * tick_ar, 0, {
                 "flash_attention": enc_fa + n * tick_fa,
                 "fused_ln_add": enc_ln + n * tick_ln})}
    return {k: (f, b, nonzero(launches))
            for k, (f, b, launches) in parts.items()}


def tp_family_parts(group, dev, refs):
    """The families' TP parts on this rank (after the other parts), each
    with the launch, path and collective counters zeroed just before and
    read just after: the forward, one train step and the greedy decode
    against ``refs`` -> {arch: {part: numbers}}."""
    from repro_torch.core import tp
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as MX
    from repro_torch.optim import adamw
    rank, size = group.rank(), group.size()
    plan = ExecutionPlan.from_group(group, tp="explicit")
    out = {}
    for arch in TP_FAMILY:
        ref = refs[arch]
        cfg, full, batch = tp_family_inputs(arch, dev)
        shard = MX.shard_params(full, cfg, rank, size)
        del full
        res = {}

        def part(name, fn):
            ops.reset_launches()
            ops.reset_dispatch_paths()
            tp.reset_collectives()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize(dev)
            res[name] = dict(r, ms=(time.perf_counter() - t0) * 1e3,
                             counts=tp.collective_counts(),
                             launches=nonzero(ops.launch_counts()),
                             paths=ops.dispatch_paths())

        def forward():
            from repro_torch.models import model as M
            with torch.no_grad():
                logits = M.forward(shard, cfg, batch, plan)[0]
            return {"err": max_err(logits, ref["logits"]),
                    "top": ref["logits"].abs().max().item(),
                    "sum": logits.sum().item()}

        def decode():
            tokens = tp_family_decode(cfg, shard, batch, plan)
            return {"tokens": tokens.tolist(), "equal": bool(torch.equal(
                tokens, ref["tokens"]))}

        def train():
            state, loss, gnorm = tp_family_step(cfg, shard, batch, plan)
            got = dict(adamw.named_leaves(state["params"]))
            err = max(max_err(t, got[p]) for p, t in
                      adamw.named_leaves(ref["params"]))
            return {"loss": loss, "grad_norm": gnorm, "param_err": err,
                    "loss_ref": ref["loss"], "grad_norm_ref":
                    ref["grad_norm"]}

        part("forward", forward)
        part("decode", decode)
        part("train", train)
        out[arch] = res
        del shard
        torch.cuda.empty_cache()
    return out


def tp_family_report(ranks):
    """Print and gate the families' TP parts; returns rank 0's launches by
    arch and part."""
    from repro_torch.kernels import ops
    for arch in TP_FAMILY:
        cfg = tp_family_config(arch)
        want = tp_family_expected(cfg)
        _, B, S = TP_FAMILY[arch]
        for r in ranks:
            res = r["family"][arch]
            f, d, t = res["forward"], res["decode"], res["train"]
            tol = TP_SERVE_FP32_TOL * max(1.0, f["top"])
            print(f"  rank {r['rank']}: TP {arch} (full width, "
                  f"{TP_FAMILY[arch][0]}, fp32, B={B}, S={S}): forward "
                  f"logits vs one device max |diff| {f['err']:.3e} (max "
                  f"|logit| {f['top']:.3f}; tol {tol:.3g}); one train step "
                  f"loss {t['loss']:.6f} / {t['loss_ref']:.6f}, grad norm "
                  f"{t['grad_norm']:.5f} / {t['grad_norm_ref']:.5f}, params "
                  f"max |diff| {t['param_err']:.3e} (tol "
                  f"{TP_SERVE_FP32_TOL:g}, relative for the loss and norm); "
                  f"{TP_FAMILY_TICKS} greedy ticks equal to one device: "
                  f"{d['equal']}; ms forward {f['ms']:.1f} / step "
                  f"{t['ms']:.1f} / decode {d['ms']:.1f}", flush=True)
            require(f["err"] <= tol, f"{arch}: TP logits disagree with one "
                    f"device")
            require(abs(t["loss"] - t["loss_ref"]) <= TP_SERVE_FP32_TOL
                    * max(1.0, t["loss_ref"]) and abs(
                        t["grad_norm"] - t["grad_norm_ref"])
                    <= TP_SERVE_FP32_TOL * t["grad_norm_ref"]
                    and t["param_err"] <= TP_SERVE_FP32_TOL,
                    f"{arch}: the TP train step disagrees with one device")
            require(d["equal"], f"{arch}: TP greedy tokens differ from one "
                    f"device's")
            for name in ("forward", "train", "decode"):
                ar, back, launches = want[name]
                got = res[name]
                c = got["counts"]
                c_ar = _ar(c)
                paths = {k: ops.CUDA for k in launches
                         if not k.endswith(".bwd")}
                print(f"    {name}: all-reduces forward {c_ar} (want {ar}), "
                      f"backward {_ar(c, 'backward')} (want {back}), step "
                      f"{_ar(c, 'step')}; launches {got['launches']} (want "
                      f"{launches}); paths {got['paths']}", flush=True)
                # the train step's sums over the group: the partial
                # gradients (fal's fused blocks' norms) and the norm
                step = int(name == "train") * (1 + int(
                    cfg.connection == "fal" and cfg.family != "ssm"))
                require(c_ar == ar and _ar(c, "backward") == back
                        and _ar(c, "step") == step,
                        f"{arch} {name}: TP all-reduce counts")
                require(got["launches"] == launches,
                        f"{arch} {name}: launches {got['launches']} != "
                        f"{launches}")
                require(got["paths"] == paths,
                        f"{arch} {name}: paths {got['paths']}")
        require(len({r["family"][arch]["forward"]["sum"] for r in ranks}) == 1
                and len({str(r["family"][arch]["decode"]["tokens"])
                         for r in ranks}) == 1,
                f"{arch}: TP ranks disagree")
    return {a: {k: v["launches"] for k, v in ranks[0]["family"][a].items()}
            for a in TP_FAMILY}


def family_config(arch, **kw):
    from repro_torch.configs.base import get_config
    return get_config(arch).replace(**kw)


def family_batch(cfg, B, S, g, device):
    """Tokens (B, S) and, for whisper, frames (B, n_enc_frames, d) drawn
    from ``g`` (a generator on ``device``)."""
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     device=device, dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.n_enc_frames, cfg.d_model),
                                      generator=g, device=device)
    return batch


def family_expected(cfg, steps=1, ticks=0):
    """Launches of the family's kernels: ``steps`` remat training steps
    (each block's forward twice, its backward once) plus ``ticks`` decode
    ticks.  zamba: one flash call and one LN-add (fal's MLP input) per
    shared-block invocation; whisper: per encoder block one flash call
    (bidirectional) and one LN-add, per decoder block two flash calls
    (causal self-attention, cross-attention; one, the cross, at decode)
    and one LN-add; mamba: none."""
    if cfg.family == "hybrid":
        n = cfg.n_layers // cfg.attn_every
        fa = ln = n
        tick_fa, tick_ln = 0, n
    elif cfg.family == "audio":
        fa, ln = cfg.n_enc_layers + 2 * cfg.n_layers, \
            cfg.n_enc_layers + cfg.n_layers
        tick_fa = tick_ln = cfg.n_layers
    else:
        return {}
    return {"flash_attention": 2 * steps * fa + ticks * tick_fa,
            "flash_attention.bwd": steps * fa,
            "fused_ln_add": 2 * steps * ln + ticks * tick_ln,
            "fused_ln_add.bwd": steps * ln}


def family_paths(cfg):
    """The dispatch paths a family's run records on the card."""
    from repro_torch.kernels import ops
    if cfg.family == "ssm":
        return {}
    return {"flash_attention": ops.CUDA, "fused_ln_add": ops.CUDA}


def family_grads(cfg, params, batch):
    """(eval logits (B, S, V) fp32 on the host, loss, gradient norm) of
    ``params`` on ``batch``; the gradients are cleared after."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    leaves = [t for _, t in adamw.named_leaves(params)]
    with torch.no_grad():
        logits = M.forward(params, cfg, batch, "eval")[0].float().cpu()
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = M.loss_fn(params, cfg, batch)
    loss.backward()
    gnorm = torch.stack([t.grad.float().square().sum()
                         for t in leaves]).sum().sqrt().item()
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    return logits, loss.item(), gnorm


def family_decode(cfg, params, batch, n, device, cache_dtype="float32"):
    """``n`` decode_step ticks feeding batch's tokens at positions 0..n-1
    (whisper: ``enc_out`` from ``whisper_encode`` first) -> (n, B, V) fp32
    logits on the host."""
    from repro_torch.models import model as M
    B = batch["tokens"].shape[0]
    out = []
    with torch.no_grad():
        cache = M.init_cache(cfg, B, n, cache_dtype, device=device)
        if cfg.family == "audio":
            cache["enc_out"].copy_(M.whisper_encode(params, cfg,
                                                    batch["frames"]))
        for t in range(n):
            logits, cache = M.decode_step(
                params, cfg, {"tokens": batch["tokens"][:, t:t + 1],
                              "pos": torch.full((B,), t, dtype=torch.int32,
                                                device=device)}, cache)
            out.append(logits[:, 0].float().cpu())
    return torch.stack(out)


def family_tick_phase():
    """(a) Each family at full width in fp32, cut in depth (FAMILY_TICKS),
    on the card (kernels) and on the CPU (plain versions) from the same
    weights and batch: eval logits, loss, gradient norm and
    FAMILY_DECODE_TICKS decode_step ticks; the card's paths."""
    from repro_torch import interop
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    for arch in FAMILIES:
        cut, B, S = FAMILY_TICKS[arch]
        cfg = family_config(arch, dtype="float32", **cut)
        phase(f"{arch} at full width, {cut}, fp32, B={B}, S={S}: logits, "
              f"loss, gradient norm and {FAMILY_DECODE_TICKS} decode_step "
              f"ticks, card (kernels) vs CPU (plain)")
        t0 = time.perf_counter()
        cpu_params = M.init_params(cfg, seed=0, device="cpu",
                                   dtype="float32")
        gparams = interop.tree_to(cpu_params, "cuda")
        batch = family_batch(cfg, B, S, torch.Generator().manual_seed(17),
                             "cpu")
        gbatch = {k: v.cuda() for k, v in batch.items()}
        n = FAMILY_DECODE_TICKS
        ops.reset_launches()
        ops.reset_dispatch_paths()
        card = family_grads(cfg, gparams, gbatch) + (
            family_decode(cfg, gparams, gbatch, n, "cuda"),)
        torch.cuda.synchronize()
        counts, paths = ops.launch_counts(), ops.dispatch_paths()
        del gparams
        torch.cuda.empty_cache()
        cpu = family_grads(cfg, cpu_params, batch) + (
            family_decode(cfg, cpu_params, batch, n, "cpu"),)
        top = cpu[0].abs().max().item()
        d_logit = (card[0] - cpu[0]).abs().max().item()
        d_loss = abs(card[1] - cpu[1])
        d_norm = abs(card[2] - cpu[2]) / cpu[2]
        d_dec = (card[3] - cpu[3]).abs().max().item()
        tol = TICK_TOLS[""] * max(1.0, top)
        print(f"  logits max |diff| {d_logit:.3e} (max |logit| {top:.3f}; "
              f"tol {tol:.3g}); loss card {card[1]:.6f} CPU {cpu[1]:.6f} "
              f"(|diff| {d_loss:.3e}, tol {FAMILY_LOSS_TOL:g}); grad norm "
              f"{card[2]:.5f} / {cpu[2]:.5f} (relative {d_norm:.3e}, tol "
              f"{FAMILY_GNORM_RTOL:g}); {n} decode ticks max |diff| "
              f"{d_dec:.3e} (tol {tol:.3g}); card paths {paths}; launches "
              f"{nonzero(counts)}; {time.perf_counter() - t0:.1f} s",
              flush=True)
        require(paths == family_paths(cfg), f"{arch}: card paths {paths}")
        require(d_logit <= tol and d_dec <= tol
                and bool(torch.isfinite(card[3]).all()),
                f"{arch}: card logits disagree with the CPU")
        require(d_loss <= FAMILY_LOSS_TOL and d_norm <= FAMILY_GNORM_RTOL,
                f"{arch}: card loss or gradient norm disagrees with the CPU")
        del cpu_params, card, cpu


def family_fwd_check(cfg, params):
    """decode_step == forward at full depth in bf16: FAMILY_FWD_B lanes of
    FAMILY_FWD_S tokens, every logit within FAMILY_FWD_BOUND -> (max
    |diff|, share of positions whose greedy tokens agree)."""
    from repro_torch.models import model as M
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = family_batch(cfg, FAMILY_FWD_B, FAMILY_FWD_S, g, "cuda")
    with torch.no_grad():
        full = M.forward(params, cfg, batch, "eval")[0].float().cpu()
    dec = family_decode(cfg, params, batch, FAMILY_FWD_S, "cuda",
                        "bfloat16").transpose(0, 1)
    err = (dec - full).abs().max().item()
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"  decode == forward ({FAMILY_FWD_B} lanes x {FAMILY_FWD_S} "
          f"tokens, bf16): logits max |diff| {err:.4f} (bound "
          f"{FAMILY_FWD_BOUND}; max |logit| {full.abs().max().item():.3f}); "
          f"greedy tokens agree at {agree:.4f} of the positions", flush=True)
    require(err <= FAMILY_FWD_BOUND and bool(torch.isfinite(dec).all()),
            f"{cfg.arch_id}: decode differs from forward by {err}")
    return err, agree


def family_batcher(cfg, params, smi, dual=False):
    """FAMILY_REQS greedy requests of FAMILY_PROMPT + FAMILY_NEW tokens
    through ContinuousBatcher (FAMILY_SLOTS slots, bf16 cache), the
    counters zeroed just before and read just after; then
    BATCHER_PROFILED_TICKS full ticks under torch.profiler.  -> (streams,
    numbers)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve.decode import ContinuousBatcher, Request
    max_seq = FAMILY_PROMPT + FAMILY_NEW + 1
    rng = np.random.default_rng(13)
    warm = ContinuousBatcher(cfg, params, 2, 16, cache_dtype="bfloat16",
                             dual_branch=dual)
    warm.submit(Request(rid=-1, prompt=rng.integers(0, cfg.vocab, 4),
                        max_new=2))
    warm.run()
    del warm
    eng = ContinuousBatcher(cfg, params, FAMILY_SLOTS, max_seq,
                            cache_dtype="bfloat16", dual_branch=dual)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, FAMILY_PROMPT),
                    max_new=FAMILY_NEW) for i in range(FAMILY_REQS)]
    for r in reqs:
        eng.submit(r)
    tick_ms, done = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    ops.reset_dispatch_paths()
    t0 = time.perf_counter()
    while any(s is not None for s in eng.slots) or eng.queue:
        t1 = time.perf_counter()
        done += eng.step()        # ends in the next tokens' copy to the host
        tick_ms.append((time.perf_counter() - t1) * 1e3)
    secs = time.perf_counter() - t0
    counts, paths = ops.launch_counts(), ops.dispatch_paths()
    st = eng.stats()
    n_tok = sum(len(r.generated) for r in done)
    p50, p99 = np.percentile(tick_ms, [50, 99])
    want = family_expected(cfg, steps=0, ticks=st["ticks"])
    print(f"  ContinuousBatcher{' (dual_branch)' if dual else ''}: "
          f"{len(done)} requests, {st['ticks']} ticks in {secs:.2f} s: "
          f"{n_tok / secs:.1f} generated tok/s; ms a tick p50 {p50:.2f} p99 "
          f"{p99:.2f}; mean occupancy {st['mean_occupancy']:.3f}; paths "
          f"{paths}; launches {nonzero(counts)} (want {nonzero(want)}); "
          f"card {smi}", flush=True)
    require(len(done) == FAMILY_REQS
            and all(len(r.generated) == FAMILY_NEW for r in done),
            "the batcher left a request unfinished")
    require(paths == ({} if cfg.family == "ssm"
                      else {"fused_ln_add": ops.CUDA}),
            f"{cfg.arch_id} batcher paths {paths}")
    require(nonzero(counts) == nonzero(want),
            f"{cfg.arch_id} batcher launches {nonzero(counts)} != "
            f"{nonzero(want)}")
    for r in reqs[:FAMILY_SLOTS]:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new=FAMILY_NEW))
    eng.step()
    busy = tick_device_time(
        f"{cfg.arch_id} batcher tick ({FAMILY_SLOTS} lanes)",
        lambda: [eng.step() for _ in range(BATCHER_PROFILED_TICKS)],
        float(p50), BATCHER_PROFILED_TICKS,
        want=() if cfg.family == "ssm" else ("ln_add_fwd_kernel",))
    streams = {r.rid: list(r.generated) for r in done}
    return streams, {"tok_s": n_tok / secs, "tick_ms_p50": float(p50),
                     "tick_ms_p99": float(p99), "tick_device_ms": busy,
                     "busy": None if busy is None else busy / float(p50),
                     "launches": counts.get("fused_ln_add", 0)}


def whisper_serve(cfg, params, smi):
    """Encode WHISPER_SERVE_B x 1,500 frames, then WHISPER_NEW greedy
    decode_step ticks against ``enc_out`` (the counters zeroed just before
    the encoder and read after the last tick); decode == forward over the
    fed tokens."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    B, n = WHISPER_SERVE_B, WHISPER_NEW
    g = torch.Generator(device="cuda").manual_seed(23)
    frames = family_batch(cfg, B, 1, g, "cuda")["frames"]
    tok = torch.randint(0, cfg.vocab, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    with torch.no_grad():                                   # warm-up
        M.whisper_encode(params, cfg, frames[:1])
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.reset_dispatch_paths()
        t0 = time.perf_counter()
        enc = M.whisper_encode(params, cfg, frames)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        cache = M.init_cache(cfg, B, n, "bfloat16")
        cache["enc_out"].copy_(enc)
        fed, logits = [], []
        t0 = time.perf_counter()
        for t in range(n):
            fed.append(tok)
            lg, cache = M.decode_step(
                params, cfg, {"tokens": tok[:, None],
                              "pos": torch.full((B,), t, dtype=torch.int32,
                                                device="cuda")}, cache)
            logits.append(lg[:, 0].float())
            tok = lg[:, 0].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, paths = ops.launch_counts(), ops.dispatch_paths()
        fed = torch.stack(fed, 1)
        full = M.forward(params, cfg, {"tokens": fed, "frames": frames},
                         "eval")[0].float()
    dec = torch.stack(logits, 1)
    err = (dec - full).abs().max().item()
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    want = {"flash_attention": Le + n * Ld, "fused_ln_add": Le + n * Ld}
    print(f"  whisper: encode {B} x {cfg.n_enc_frames} frames {enc_ms:.1f} "
          f"ms; {n} decode ticks of {B} lanes in {secs:.2f} s = "
          f"{secs / n * 1e3:.2f} ms a tick, {B * n / secs:.1f} tok/s; decode "
          f"== forward: logits max |diff| {err:.4f} (bound "
          f"{FAMILY_FWD_BOUND}), greedy tokens agree at {agree:.4f}; paths "
          f"{paths}; launches {nonzero(counts)} (want {want}); card {smi}",
          flush=True)
    require(paths == family_paths(cfg), f"whisper serving paths {paths}")
    require(nonzero(counts) == want, "whisper serving launches")
    require(err <= FAMILY_FWD_BOUND and bool(torch.isfinite(dec).all()),
            f"whisper: decode differs from forward by {err}")
    return {"encode_ms": enc_ms, "tick_ms": secs / n * 1e3,
            "tok_s": B * n / secs, "fwd_err": err, "launches": want}


def family_serve_phase(smi):
    """(b) bf16 serving at full depth: mamba2 and zamba2 decode == forward
    and through ContinuousBatcher (zamba also under dual_branch: the same
    streams); whisper's encoder and decode ticks.  -> {arch: numbers}."""
    from repro_torch.models import model as M
    out = {}
    for arch in FAMILIES:
        cfg = family_config(arch)
        phase(f"{arch} serving, full depth ({cfg.n_layers} layers"
              f"{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}"
              f"), bf16")
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed=0)
        if cfg.family == "audio":
            out[arch] = whisper_serve(cfg, params, smi)
        else:
            err, agree = family_fwd_check(cfg, params)
            streams, res = family_batcher(cfg, params, smi)
            res.update(fwd_err=err, fwd_agree=agree)
            if cfg.family == "hybrid":
                dual, res["dual"] = family_batcher(cfg, params, smi,
                                                   dual=True)
                require(dual == streams, "zamba's dual-branch streams "
                        "differ from the sequential ones")
                print("  dual-branch streams equal the sequential ones",
                      flush=True)
            out[arch] = res
        print(f"  {arch} serving: {time.perf_counter() - t0:.1f} s",
              flush=True)
        del params
        torch.cuda.empty_cache()
    return out


def family_train_phase():
    """(c) Training at full depth (fp32 masters, bf16 compute, remat,
    FAMILY_TRAIN's batch and sequence): one warm-up step, then
    FAMILY_TRAIN_STEPS - 1 counted steps (the counters zeroed after the
    warm-up and read after the last), then one step under torch.profiler.
    mamba2 and zamba2 through ``trainer.train``; whisper through
    ``train.step.make_train_step`` on batches with frames (the trainer's
    data makes none, nor does the reference's).  -> ({arch: launches},
    {arch: numbers})."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train import trainer
    launches, out = {}, {}
    for arch in FAMILIES:
        cfg = family_config(arch)
        B, S = FAMILY_TRAIN[arch]
        steps = FAMILY_TRAIN_STEPS
        phase(f"train: {arch} at full depth, fp32 masters, {cfg.dtype} "
              f"compute, remat {cfg.remat}, B={B}, S={S}, {steps - 1} steps "
              f"after 1 warm-up")
        marks, hist = [], []

        def mark(i, state, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if i == 0:
                ops.reset_launches()
                ops.reset_dispatch_paths()
                torch.cuda.reset_peak_memory_stats()

        g = torch.Generator(device="cuda").manual_seed(31)
        ocfg = adamw.AdamWConfig(lr=3e-4)
        if cfg.family == "audio":
            state = tstep.init_state(0, cfg, ocfg)
            step = tstep.make_train_step(cfg, ocfg)
            for i in range(steps):
                state, m = step(state, family_batch(cfg, B, S, g, "cuda"))
                hist.append({k: float(v) for k, v in m.items()})
                mark(i, state, m)
        else:
            state, hist = trainer.train(cfg, steps=steps, batch=B,
                                        seq_len=S, log_every=1,
                                        device="cuda", callbacks=[mark])
            step = tstep.make_train_step(cfg, ocfg)
        counts, paths = ops.launch_counts(), ops.dispatch_paths()
        peak = torch.cuda.max_memory_allocated()
        n_par = sum(t.numel() for _, t in adamw.named_leaves(
            state["params"]))
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        ms = statistics.median(step_ms)
        want = family_expected(cfg, steps=steps - 1)
        batch = family_batch(cfg, B, S, g, "cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        device_ms = busy_ms(prof)
        res = dict(step_ms=ms, tok_s=B * S / ms * 1e3, peak=peak,
                   n_params=n_par, B=B, S=S)
        if device_ms:
            res.update(device_ms=device_ms, busy=device_ms / wall)
        print(f"  {n_par / 1e9:.3f} B parameters; losses "
              f"{[round(h['loss'], 4) for h in hist]}; step ms "
              f"{['%.1f' % x for x in step_ms]} (median {ms:.1f}); "
              f"{B * S / ms * 1e3:.1f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB (counted steps); profiled step: wall "
              f"{wall:.1f} ms, device time "
              f"{'not measured' if not device_ms else f'{device_ms:.1f} ms, busy share {device_ms / wall:.3f}'}; "
              f"paths {paths}; launches {nonzero(counts)} (want {want})",
              flush=True)
        require(all(math.isfinite(h["loss"]) for h in hist),
                f"{arch} train: a loss is not finite")
        require(paths == family_paths(cfg), f"{arch} train paths {paths}")
        require(nonzero(counts) == want, f"{arch} train launches "
                f"{nonzero(counts)} != {want}")
        launches[arch], out[arch] = want, res
        del state, step, batch
        torch.cuda.empty_cache()
    return launches, out


# --------------------------------------------------------------------------- #
# phase 18: the paper's §3 motivation analyses (core/analysis.py)
# --------------------------------------------------------------------------- #
#: benchmarks/bench_motivation.py's model (:18-21) and run: 6 layers of
#: width 192, preln, fp32, SyntheticMarkov(1024, 128, 16, seed=23), 150
#: trainer steps at lr 1e-3
ANALYSIS_STEPS = 150
#: card vs CPU on the same weights: test_torch_analysis.py's tolerances
ANALYSIS_CKA_TOL = 1e-5
ANALYSIS_GRAD_RTOL = 1e-4
ANALYSIS_PPL_RTOL = 1e-5


def analysis_config():
    from repro_torch.configs.base import get_config
    return get_config("gpt2-117m").replace(
        n_layers=6, d_model=192, n_heads=6, n_kv_heads=6, d_ff=768,
        vocab=1024, max_seq=128, dtype="float32", param_dtype="float32",
        remat=False, connection="preln", attn_block_q=64, attn_block_k=128)


def analysis_run(params, cfg, batch):
    """Every analysis of ``core.analysis`` on ``params`` / ``batch`` (on
    their device): Fig 3a's CKA table, Fig 4a's gradient magnitudes, Fig
    4b's per-layer ablations and Fig 3b's triple."""
    from repro_torch.core import analysis as AN
    out = {"cka": AN.cka_table(params, cfg, batch),
           "mags": AN.mha_gradient_magnitudes(params, cfg, batch),
           "base": AN.ablate_attention_perplexity(params, cfg, batch)}
    out["drops"] = [AN.ablate_attention_perplexity(params, cfg, batch,
                                                   drop_layer=i)
                    for i in range(cfg.n_layers)]
    out["no_conn"] = AN.ablate_attention_perplexity(
        params, cfg, batch, drop_connections=True)
    out["no_mha"] = AN.ablate_attention_perplexity(params, cfg, batch,
                                                   drop_all_mha=True)
    return out


def analysis_phase():
    """The card twin of ``benchmarks/bench_motivation.py``: train its model
    150 steps on the card, then run every analysis on the card (the flash
    kernels forward, and backward for the gradient magnitudes) and on the
    CPU (their plain versions) on the same weights; gate the parity, print
    the paper's findings (not gated).  Returns the analyses' launches."""
    from repro_torch import interop
    from repro_torch.data.pipeline import SyntheticMarkov
    from repro_torch.kernels import ops
    from repro_torch.train import trainer
    cfg = analysis_config()
    phase(f"analysis: bench_motivation's model (gpt2-117m widths cut to "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.connection}, "
          f"fp32), {ANALYSIS_STEPS} trainer steps on the card, then "
          f"core.analysis card vs CPU")
    data = SyntheticMarkov(cfg.vocab, 128, 16, seed=23)
    t0 = time.perf_counter()
    state, hist = trainer.train(cfg, steps=ANALYSIS_STEPS, batch=16,
                                seq_len=128, data=data, log_every=0,
                                lr=1e-3, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    params = state["params"]
    batch = {"tokens": torch.from_numpy(data.batch_at(10 ** 6)["tokens"])}
    ops.reset_launches()
    ops.reset_dispatch_paths()
    t0 = time.perf_counter()
    card = analysis_run(params, cfg, interop.tree_to(batch, "cuda"))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    paths = ops.dispatch_paths()
    cpu = analysis_run(interop.tree_to(params, "cpu"), cfg, batch)
    L = cfg.n_layers
    print(f"  trained {ANALYSIS_STEPS} steps in {train_s:.1f} s (last loss "
          f"{hist[-1]['loss'] if hist else float('nan'):.4f}); analyses on "
          f"the card {card_s:.2f} s; launches {launches}; paths {paths}",
          flush=True)
    for k in ("mha_out", "mlp_in", "mlp_out"):
        err = max(abs(a - b) for a, b in zip(card["cka"][k], cpu["cka"][k]))
        print(f"  Fig 3a CKA {k}: avg {sum(card['cka'][k]) / (L - 1):.4f} "
              f"(card) / {sum(cpu['cka'][k]) / (L - 1):.4f} (CPU); "
              f"consecutive blocks {[round(v, 4) for v in card['cka'][k]]};"
              f" card vs CPU max |diff| {err:.2e} (tol {ANALYSIS_CKA_TOL})",
              flush=True)
        require(err <= ANALYSIS_CKA_TOL, f"CKA {k}: card vs CPU")
    mags = card["mags"]
    rank1 = sorted(mags, reverse=True).index(mags[0]) + 1
    err = max(abs(a - b) / abs(b) for a, b in zip(mags, cpu["mags"]))
    print(f"  Fig 4a |dLoss/dMHA_i| per block: "
          f"{[round(m, 2) for m in mags]}; block 1 ranks {rank1} of {L}; "
          f"card vs CPU max relative diff {err:.2e} (tol "
          f"{ANALYSIS_GRAD_RTOL})", flush=True)
    require(err <= ANALYSIS_GRAD_RTOL, "gradient magnitudes: card vs CPU")
    pp = [card["base"], *card["drops"], card["no_conn"], card["no_mha"]]
    pc = [cpu["base"], *cpu["drops"], cpu["no_conn"], cpu["no_mha"]]
    err = max(abs(a - b) / abs(b) for a, b in zip(pp, pc))
    print(f"  Fig 4b perplexity: base {card['base']:.3f}, dropping block "
          f"i's MHA {[round(p, 3) for p in card['drops']]}; Fig 3b: "
          f"original {card['base']:.3f}, all MHA->MLP connections removed "
          f"{card['no_conn']:.3f}, all MHA removed {card['no_mha']:.3f}; "
          f"card vs CPU max relative diff {err:.2e} (tol "
          f"{ANALYSIS_PPL_RTOL})", flush=True)
    require(err <= ANALYSIS_PPL_RTOL, "ablation perplexities: card vs CPU")
    # forward: the CKA pass, the gradient pass and 1 + L + 2 ablations;
    # backward: the gradient pass, in every block but block 0 (whose
    # attention inputs depend on no perturbation)
    want = {"flash_attention": L * (L + 5), "flash_attention.bwd": L - 1}
    got = {k: launches.get(k, 0) for k in want}
    require(got == want, f"analysis launches {got} != {want}")
    require(paths.get("flash_attention") == ops.CUDA,
            "the card's analyses did not run the flash kernel")
    return got


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
            "fused_dual_branch_decode": fused_kernel_phase(),
            "page_copy": page_copy_phase(),
            **scale_kernel_phase(),
            **flash_kernel_phase(), **ln_kernel_phase()}
    times = time_phase(bw)
    main_shape = "mixed tick (256 prefill + 7 decode near 1024 + 9 pad)"
    copy_times = page_copy_time_phase(bw)
    decode_shape = "decode tick (8 tokens x ~64 pages)"
    times = {"paged_packed_attention": dict(
        times[main_shape], decode_tick_ms=times[decode_shape]["ms"],
        decode_tick_bound_ms=times[decode_shape]["bound_ms"],
        decode_tick_no_lead_ms=times[decode_shape]["no_lead_ms"],
        shape=main_shape + ", bf16, H=24 Hkv=8 D=128 page=16"),
        **padded_time_phase(bw), **scale_time_phase(bw),
        **train_time_phase(bw),
        "page_copy": dict(
            copy_times["bf16, 1 page x 28 layers, 4 pool leaves"],
            shape="one COW at llama3.2-3b: 1 page x 28 layers, 4 bf16 pool "
                  "leaves (block 0 + the stacked 27-layer view, K and V)")}
    tick_phase()
    launches, eng, params, ecfg, prompts, streams = engine_phase()
    from repro_torch.configs.base import get_config
    cfg = get_config("llama3.2-3b")
    launches = {"paged_packed_attention": launches}
    t_new = time.perf_counter()
    sampler_ms = sampler_phase(cfg, params)
    seeded_launches = seeded_engine_phase(cfg, params, ecfg)
    spec = spec_engine_phase(cfg, params, ecfg)
    print(f"  sampling and speculation phases: "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    prefix = prefix_engine_phase(cfg, params, ecfg)
    launches["page_copy"] = prefix["page_copy"]
    prefix_engine_phase(cfg, params, ecfg, "int8")
    qcfg, qparams, qstreams = quantized_depth(cfg, params, ecfg, prompts)
    for kv in KV_NARROW:
        launches[f"paged_packed_attention.{kv}"] = quantized_engine_phase(
            qcfg, qparams, ecfg, prompts, qstreams, kv)
    launches.update(padded_generation_phase(params, n_new=PADDED_NEW))
    for kv in KV_NARROW:
        launches.update(padded_generation_phase(
            qparams, kv, n_new=8, order=("sequential", "dual"), cfg=qcfg))
    del qparams
    contig_launches, contig = contiguous_decode_phase(params, smi)
    del params
    torch.cuda.empty_cache()
    train_tick_phase()
    train_launches, train = train_phase()
    launches.update(train_launches)
    dry = dryrun_phase(train)
    tp_launches, tp_step_ms, tp_serve_launches, tp_fam_launches = \
        tp_phase(smi)
    t_dp = time.perf_counter()
    dp_launches, fsdp_launches, dp = dp_phase(smi)
    print(f"  data-parallel phase: {time.perf_counter() - t_dp:.1f} s",
          flush=True)
    t_g2 = time.perf_counter()
    gemma2_tick_phase()
    g2_launches, g2_train = gemma2_train_phase()
    g2_engine = gemma2_engine_phase()
    print(f"  gemma2 phases: {time.perf_counter() - t_g2:.1f} s", flush=True)
    t_moe = time.perf_counter()
    moe_tick_phase()
    moe_eng = moe_engine_phase()
    moe_train_launches, moe_train = moe_train_phase()
    moe_tp_launches = moe_dist_phase(smi)
    print(f"  MoE phases: {time.perf_counter() - t_moe:.1f} s", flush=True)
    t_mla = time.perf_counter()
    mla_tick_phase()
    mla_eng = mla_engine_phase()
    mla_train_launches, mla_train = mla_train_phase()
    vlm = vlm_phase()
    print(f"  MLA and VLM phases: {time.perf_counter() - t_mla:.1f} s",
          flush=True)
    t_fam = time.perf_counter()
    family_tick_phase()
    fam_serve = family_serve_phase(smi)
    fam_train_launches, fam_train = family_train_phase()
    print(f"  SSM, hybrid and audio phases: "
          f"{time.perf_counter() - t_fam:.1f} s", flush=True)
    t_an = time.perf_counter()
    analysis_launches = analysis_phase()
    print(f"  analysis phase: {time.perf_counter() - t_an:.1f} s",
          flush=True)
    example_launches = examples_phase()
    src = "src/repro_torch/kernels/csrc/"
    pa = "src/repro/kernels/paged_attention.py"
    where = {
        # bf16 q on bf16 pages (the timed and main-path case): the
        # tensor-core kernels, built as part of paged_attention.cu
        "paged_packed_attention": ("paged_packed_tc.cuh", f"{pa}:346"),
        "paged_decode_attention": ("paged_attention.cu", f"{pa}:106"),
        # bf16 q on bf16, int8 or fp8 pages: the same tensor-core kernels
        # over chunk items
        "paged_chunk_attention": ("paged_packed_tc.cuh", f"{pa}:222"),
        "fused_dual_branch_decode": ("dual_branch.cu",
                                     "src/repro/kernels/dual_branch.py:122"),
        "page_copy": ("page_copy.cu", f"{pa}:420"),
        "flash_attention": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:76"),
        "fused_ln_add": ("fused_ln_add.cu",
                         "src/repro/kernels/fused_ln_add.py:37"),
    }
    for kname in ("flash_attention", "fused_ln_add"):
        # the backward kernels replace XLA's autodiff of the same TPU kernel
        where[f"{kname}.bwd"] = where[kname]
    for kv in KV_NARROW:
        # the scale variants come from the same sources (bf16 q on int8 /
        # fp8 pages: the packed and chunk ones the tensor-core kernels too)
        for kname in ("paged_packed_attention", "paged_decode_attention",
                      "paged_chunk_attention"):
            where[f"{kname}.{kv}"] = where[kname]
    kernels = []
    for kname, (source, replaces) in where.items():
        row = times[kname]
        require(launches[kname] > 0, f"{kname} was not launched on its "
                f"main-path run")
        entry = {"name": kname, "route": "cuda", "source": src + source,
                 "replaces": replaces, "launches": launches[kname],
                 "max_abs_err": errs[kname], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row.get("library_ms")}
        # the row's other measurements (times without a lead, other
        # shapes, parts of a kernel), then its shape
        entry.update({k: v for k, v in row.items()
                      if k not in entry and k != "shape"})
        if kname == "paged_packed_attention":
            entry.update(seeded_engine_launches=seeded_launches,
                         spec_engine_launches=spec["launches"],
                         spec_engine_formula=spec["formula"],
                         moe_engine_launches=moe_eng["launches"],
                         moe_engine_formula=f"ticks x layers = "
                         f"{moe_eng['ticks']} x {MOE_ENGINE_LAYERS}")
            entry["vlm_launches"] = vlm["launches"]
        elif kname == "fused_ln_add":
            entry.update(spec_engine_launches=spec["ln_launches"],
                         spec_engine_formula=spec["formula"],
                         gemma2_engine_launches=g2_engine["launches"],
                         contiguous_decode_launches=contig_launches[
                             "decode_step"],
                         batcher_launches=contig_launches["batcher"],
                         seq_decode_launches=dp["seq_launches"],
                         moe_engine_launches=moe_eng["ln_launches"],
                         mla_engine_launches=mla_eng["ln_launches"],
                         vlm_launches=vlm["ln_launches"])
        elif kname == "page_copy":
            entry["mla_engine_launches"] = mla_eng["copy_launches"]
        elif kname == "fused_dual_branch_decode":
            # MoE blocks take the unfused route on C == 1 ticks
            entry["moe_engine_launches"] = 0
        if kname in moe_train_launches:
            # the MoE training path (3 counted steps, 2 layers, remat) and
            # rank 0's launches on the MoE TP forward and trainer step
            entry["moe_train_launches"] = moe_train_launches[kname]
            entry["moe_tp_launches"] = {
                "forward": moe_tp_launches[0].get(kname, 0),
                "train": moe_tp_launches[1].get(kname, 0)}
        if kname in tp_launches:
            # rank 0's launches on the tensor-parallel paths (phase 13a)
            entry["tp_launches"] = tp_launches[kname]
        if kname in tp_serve_launches:
            # of which rank 0's on the TP serving ticks and engines
            entry["tp_serving_launches"] = tp_serve_launches[kname]
        if kname in dp_launches:
            # rank 0's launches on the tp x dp paths (phase 13b)
            entry["dp_launches"] = dp_launches[kname]
        if kname in fsdp_launches:
            # of phase 13b, rank 0's on the FSDP steps
            entry["fsdp_launches"] = fsdp_launches[kname]
        if kname in g2_launches:
            # the gemma2 training path (3 counted steps, 2 layers, remat)
            # and the window / softcap check's error at its shape
            entry.update(gemma2_launches=g2_launches[kname],
                         gemma2_max_abs_err=errs[f"{kname}.gemma2"])
        if kname.startswith(("flash_attention", "fused_ln_add")):
            # phase 17: each family's counted training steps and serving
            # runs (the batchers' ticks, whisper's encoder + decode ticks)
            entry["family_train_launches"] = {
                a: n.get(kname, 0) for a, n in fam_train_launches.items()}
            entry["family_serve_launches"] = {
                a: (r["launches"].get(kname, 0) if a == AUDIO_ARCH
                    else r["launches"] if kname == "fused_ln_add" else 0)
                for a, r in fam_serve.items()}
            if f"{kname}.whisper" in errs:
                entry["whisper_max_abs_err"] = errs[f"{kname}.whisper"]
            # phase 13a: rank 0's launches on each family's TP forward,
            # train step and greedy decode
            entry["tp_family_launches"] = {
                a: sum(n.get(kname, 0) for n in parts.values())
                for a, parts in tp_fam_launches.items()}
        # the example twins' runs at their defaults (phase 19)
        entry["example_launches"] = {
            name: n.get(kname, 0) for name, n in example_launches.items()}
        if kname in analysis_launches:
            # phase 18: core.analysis on the trained motivation model
            entry["analysis_launches"] = analysis_launches[kname]
        if kname in mla_train_launches:
            # the deepseek-v3 training path (MLA: the D = 192 kernels on
            # every layer and the MTP block), the D = 192 check's error
            entry["mla_train_launches"] = mla_train_launches[kname]
            if f"{kname}.mla" in errs:
                entry["mla_max_abs_err"] = errs[f"{kname}.mla"]
        entry["shape"] = row["shape"]
        kernels.append(entry)
    print(f"total {time.perf_counter() - t_start:.1f} s; engine "
          f"{eng['tok_s']:.1f} tok/s over {eng['ticks']} ticks; sampler ms "
          f"a call " + ", ".join(f"{k[0]}@{k[1]} {v:.3f}" for k, v in
                                 sampler_ms.items())
          + f"; seeded spec tick {spec['device_ms_per_tick']:.2f} ms of "
          f"device time; train {train['step_ms']:.1f} ms/step; TP train "
          f"(4 layers, gloo through host memory, 2 ranks on the card) "
          f"{tp_step_ms:.1f} ms/step; tp 2 x dp 2 ({DP_LAYERS} layers, "
          f"vocab {DP_VOCAB}, fp32, gloo through host memory, 4 ranks on "
          f"the card) {dp['step_ms']:.1f} "
          f"ms/step, DP all-reduce {dp['dp_all_reduce_ms']:.1f} ms, "
          f"FSDP {dp['fsdp']['step_ms']:.1f} ms/step (peak "
          f"{dp['fsdp']['peak'] / 2**30:.3f} GiB, predicted "
          f"{dp['fsdp']['predicted_peak'] / 2**30:.3f} GiB), "
          f"checkpoint save {dp['save_s']:.1f} s / restore "
          f"{dp['restore_s']:.1f} s; batcher {contig['tok_s']:.1f} tok/s, "
          f"{contig['tick_ms_p50']:.2f} ms a tick p50; gemma2 "
          f"train {g2_train['step_ms']:.1f} ms/step (peak "
          f"{g2_train['peak'] / 2**30:.2f} GiB), engine "
          f"{g2_engine['tok_s']:.1f} tok/s, prefill tick "
          f"{g2_engine['tick_device_ms']:.2f} ms of device time; "
          f"{MOE_ARCH} ({MOE_ENGINE_LAYERS} layers) engine "
          f"{moe_eng['tok_s']:.1f} tok/s, MoE train "
          f"{moe_train['step_ms']:.1f} ms/step; {MLA_ARCH} "
          f"({MLA_ENGINE_LAYERS} layers) engine {mla_eng['tok_s']:.1f} "
          f"tok/s, train ({MLA_TRAIN_LAYERS} layers + MTP) "
          f"{mla_train['step_ms']:.1f} ms/step; {VLM_ARCH} (32 layers) "
          f"prefill {vlm['prefill_tok_s']:.0f} tok/s, decode "
          f"{vlm['decode_ms']:.2f} ms a tick; "
          + "; ".join(f"{a} batcher {fam_serve[a]['tok_s']:.1f} tok/s, "
                      f"train {fam_train[a]['step_ms']:.1f} ms/step"
                      for a in (SSM_ARCH, HYBRID_ARCH))
          + f"; {AUDIO_ARCH} {fam_serve[AUDIO_ARCH]['tok_s']:.1f} tok/s, "
          f"train {fam_train[AUDIO_ARCH]['step_ms']:.1f} ms/step; dry "
          f"run peak {dry['peak'] / 2**30:.3f} GiB vs "
          f"{dry['measured'] / 2**30:.3f} GiB measured "
          f"({dry['rel_err']:+.4f}), {dry['tflops']:.1f} TFLOP/s; card "
          f"{smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
