"""Training launcher of the PyTorch port.

On the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --steps 100 --batch 8 --seq 128 --connection fal

On the CPU (the kernels' plain versions) add ``--device cpu``.
``--ckpt DIR`` saves the state after the last step (``train.checkpoint``:
the reference's npz + manifest format, which either package restores).

Explicit tensor parallelism and data parallelism run one process per rank
under torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``;
``--init-method`` defaults to torchrun's ``env://``) with the backend
named:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-3b --reduced --tp explicit [--sp] --dp 2 \
        --backend nccl

``--dp N`` makes N data-parallel replicas: with ``--tp explicit`` each of
``WORLD_SIZE / N`` ranks (TP the inner axis: ranks 0..tp-1 are data rank
0's TP group), without it pure data parallelism over ``WORLD_SIZE = N``
ranks.  ``--batch`` is the global batch; each data rank trains on its rows.
``--backend nccl`` needs one card per rank; ``gloo`` runs ranks that share
a card (or the CPU), through host memory.  Rank r runs on card
``LOCAL_RANK`` modulo the visible cards.  ``--ckpt`` writes the one-device
format from the gathered state.  ``--mesh`` (the reference's pod layouts)
and ``--tp gspmd`` raise.
"""
import argparse
import os


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
    ap.add_argument("--sp", action="store_true",
                    help="with --tp explicit: Megatron-SP sequence-parallel "
                         "LN regions")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel replicas (under torchrun)")
    ap.add_argument("--backend", default=None, choices=[None, "nccl", "gloo"],
                    help="with --tp explicit or --dp: the torch.distributed "
                         "backend")
    ap.add_argument("--init-method", default="env://")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh: the reference's pod layouts (256- and 512-chip "
            "meshes) are not part of the port's distributed slice; run "
            "data parallelism with --dp N under torchrun (with --tp "
            "explicit: tp = WORLD_SIZE / N)")
    if args.dp is not None and args.dp < 1:
        raise ValueError(f"--dp must be >= 1, got {args.dp}")
    if args.sp and args.tp != "explicit":
        raise ValueError("--sp requires --tp explicit (sequence-parallel "
                         "LN regions live inside the explicit partial-sum "
                         "stack)")

    from repro_torch.configs.base import get_config
    from repro_torch.core.plan import ExecutionPlan, TPStyle
    from repro_torch.train import trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.connection:
        cfg = cfg.replace(connection=args.connection)
    device = args.device
    joined = False
    if args.tp == "gspmd":
        ExecutionPlan(tp=TPStyle.GSPMD).validate(cfg)      # raises
    if args.tp == "explicit" or args.dp is not None:
        groups, device = _join(args)
        joined = True
        plan = ExecutionPlan.from_group(
            groups.tp, tp=args.tp or "none", sp=args.sp,
            data_group=groups.dp)
    else:
        plan = ExecutionPlan.single_device()
    plan.validate(cfg)

    print(f"training {cfg.arch_id} connection={cfg.connection} "
          f"layers={cfg.n_layers} d={cfg.d_model} tp={plan.tp.value} "
          f"x{plan.tp_size} sp={plan.sequence_parallel} dp={plan.dp_size} "
          f"device={device or 'cuda'}", flush=True)
    try:
        state, hist = trainer.train(
            cfg, steps=args.steps, batch=args.batch, seq_len=args.seq,
            lr=args.lr, seed=args.seed, plan=plan,
            num_microbatches=args.microbatches, schedule=args.schedule,
            ckpt_dir=args.ckpt, device=device)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()
    print(f"final loss {hist[-1]['loss']:.4f}")
    return state, hist


def _join(args):
    """Join the world from torchrun's variables and cut it into the TP and
    data groups -> (``core.tp.Groups``, device)."""
    import torch
    from repro_torch.core import tp
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "--tp explicit / --dp: the run needs a process group: run one "
            "process per rank under torchrun (RANK / WORLD_SIZE / "
            "LOCAL_RANK)")
    if args.backend is None:
        raise ValueError("--tp explicit / --dp need --backend nccl|gloo "
                         "(nothing picks one)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dp = args.dp or 1
    if world % dp or (args.tp != "explicit" and world != dp):
        raise ValueError(
            f"--dp {dp} over WORLD_SIZE {world}: pure data parallelism "
            f"needs WORLD_SIZE == --dp, with --tp explicit a multiple of it")
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = args.device
    if device is None or device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu")
        device = f"cuda:{local % torch.cuda.device_count()}"
        torch.cuda.set_device(torch.device(device))
    groups = tp.init_groups(args.backend, rank=rank, world_size=world,
                            tp_size=world // dp,
                            init_method=args.init_method)
    return groups, device


if __name__ == "__main__":
    main()
