"""End-to-end run of the PyTorch port: train a GPT-2-style model for a
few hundred steps with each connection mode (paper Table 1 / Fig 9 at
small scale) and compare loss curves and step time.  Twin of
``examples/train_fal_vs_baseline.py``: the same ~8M cut of gpt2-117m,
``SyntheticMarkov(seed=7)``, onecycle at lr 1e-3.

Run on the card:  PYTHONPATH=src python examples/torch_train_fal_vs_baseline.py
On the CPU (the kernels' plain versions): add ``--device cpu``.
"""
import argparse
import json
import os
import time

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticMarkov, unigram_entropy
from repro_torch.models.model import resolve_device
from repro_torch.train import trainer

MODES = ("preln", "parallel", "fal", "falplus")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full-117m", action="store_true",
                    help="use the full GPT-2 117M config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default="experiments/"
                                     "torch_train_fal_vs_baseline.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg0 = get_config("gpt2-117m")
    if not args.full_117m:
        # ~8M params: 6 layers x 256, as the reference's example cuts it
        cfg0 = cfg0.replace(n_layers=6, d_model=256, n_heads=8,
                            n_kv_heads=8, d_ff=1024, vocab=2048,
                            max_seq=args.seq, dtype="float32",
                            param_dtype="float32", remat=False,
                            attn_block_q=64, attn_block_k=128)

    data = SyntheticMarkov(cfg0.vocab, args.seq, args.batch, seed=7)
    print(f"unigram entropy floor: {unigram_entropy(data):.3f} nats")

    results = {}
    for mode in MODES:
        cfg = cfg0.replace(connection=mode)
        t0 = time.time()
        state, hist = trainer.train(cfg, steps=args.steps, batch=args.batch,
                                    seq_len=args.seq, data=data,
                                    log_every=max(args.steps // 5, 1),
                                    schedule="onecycle", lr=1e-3,
                                    device=device)
        results[mode] = {"final_loss": hist[-1]["loss"],
                         "wall_s": round(time.time() - t0, 1),
                         "curve": [(h["step"], round(h["loss"], 4))
                                   for h in hist]}
        print(f"--> {mode:9s} final {hist[-1]['loss']:.4f} "
              f"({results[mode]['wall_s']}s)\n")

    print(json.dumps({m: {k: v for k, v in r.items() if k != "curve"}
                      for m, r in results.items()}, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
