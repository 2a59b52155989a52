"""Training launcher of the PyTorch port, one device.

On the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --steps 100 --batch 8 --seq 128 --connection fal

On the CPU (the kernels' plain versions) add ``--device cpu``.  The
single-device twin of ``repro/launch/train.py``; ``--mesh``, ``--tp`` and
``--sp`` come with the port's distributed slice and raise here.
``--ckpt DIR`` saves the state after the last step (``train.checkpoint``:
the reference's npz + manifest format, which either package restores).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-117m")
    ap.add_argument("--connection", default=None,
                    help="preln|parallel|fal|falplus (default: config's)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "onecycle", "wsd"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--tp", default=None, choices=[None, "gspmd", "explicit"])
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh or args.tp or args.sp:
        raise NotImplementedError(
            "--mesh / --tp / --sp: tensor and sequence parallelism come in "
            "the distributed slice of the PyTorch port (ROADMAP.md Queue 1)")

    from repro_torch.configs.base import get_config
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.train import trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.connection:
        cfg = cfg.replace(connection=args.connection)
    plan = ExecutionPlan.single_device()
    plan.validate(cfg)

    print(f"training {cfg.arch_id} connection={cfg.connection} "
          f"layers={cfg.n_layers} d={cfg.d_model} device="
          f"{args.device or 'cuda'}", flush=True)
    state, hist = trainer.train(
        cfg, steps=args.steps, batch=args.batch, seq_len=args.seq,
        lr=args.lr, seed=args.seed, plan=plan,
        num_microbatches=args.microbatches, schedule=args.schedule,
        ckpt_dir=args.ckpt, device=args.device)
    print(f"final loss {hist[-1]['loss']:.4f}")
    return state, hist


if __name__ == "__main__":
    main()
