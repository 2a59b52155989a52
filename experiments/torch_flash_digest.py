#!/usr/bin/env python3
"""Digests of the flash-attention kernels' outputs (forward o and lse,
backward dq, dk, dv) of the PyTorch/CUDA port of the checkout at ROOT, on
one CUDA card, as one JSON line.

Run from the root of a checkout:
    python3 experiments/torch_flash_digest.py ROOT

It puts ROOT's port first on the path, builds ROOT's ``flash_attention``
library, and calls ``flash_attention_fwd_cuda`` / ``flash_attention_bwd_cuda``
without a window or a softcap (keywords every version of the wrappers
takes) on seeded inputs made on the CPU: fp32 (the CUDA-core kernels) and
bf16 (the tensor-core kernels), causal and full, at llama3.2-3b's training
shape, at gemma2-27b's heads and at small odd shapes, and once with a
q_offset.  Two trees whose kernels compute the same bits without the two
options print the same digests.  To compare a parent with a change, unpack
the parent with ``git archive`` into a git-ignored directory and run the
script once a process for each tree, in the order parent, change, change,
parent (one library of a name per process).
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import sys

import torch

#: (B, Sq, Sk, H, Hkv, D, causal, q_offset)
CASES = ((1, 2048, 2048, 24, 8, 128, True, 0),
         (1, 1024, 1024, 32, 16, 128, True, 0),
         (2, 77, 77, 4, 2, 32, True, 0),
         (3, 130, 130, 4, 1, 64, True, 0),
         (2, 91, 91, 4, 2, 64, False, 0),
         (1, 100, 260, 6, 2, 128, True, 160))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    if not torch.cuda.is_available():
        print("torch_flash_digest: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import flash_attention as FA
    assert pathlib.Path(FA.__file__).resolve().is_relative_to(root), \
        FA.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for (B, Sq, Sk, H, Hkv, D, causal, qo), dtype in (
            (c, dt) for c in CASES for dt in (torch.float32, torch.bfloat16)):
        g = torch.Generator().manual_seed(Sq * 7 + Sk + D)
        q, do = (torch.randn(B, Sq, H, D, generator=g) for _ in range(2))
        k, v = (torch.randn(B, Sk, Hkv, D, generator=g) for _ in range(2))
        q, k, v, do = (t.to(dtype).cuda() for t in (q, k, v, do))
        kw = dict(causal=causal, q_offset=qo)
        o, lse = FA.flash_attention_fwd_cuda(q, k, v, **kw)
        grads = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        name = (f"B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} "
                f"{'causal' if causal else 'full'} q_offset={qo} "
                f"{str(dtype)[6:]}")
        out[name] = {"fwd": digest(o, lse), "bwd": digest(*grads)}
    print(json.dumps({"root": str(root), "digests": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
