"""Explicit tensor and sequence parallelism over ``torch.distributed``.

Port of ``repro/core/tp.py``.  The reference runs its partial-sum stack
under one ``shard_map`` and lets JAX transpose the collectives; here each
rank is a process holding its shard of the block weights
(``launch/mesh.py::shard_params``) and the collectives are
``torch.autograd.Function``s with Megatron's forward / backward pairs:

  assemble      all-reduce forward, identity backward (Megatron's *g*)
  enter         identity forward, all-reduce backward (*f*): placed once
                where a replicated tensor enters a block's sharded branches
                and once on FAL's exported first-attention signal, so a
                fused block pays one all-reduce in the backward as in the
                forward
  scatter_seq   reduce-scatter along the sequence; backward all-gather
  gather_seq    all-gather along the sequence; backward reduce-scatter
  split_seq     this rank's slice of a replicated tensor; backward
                all-gather
  unsplit_seq   all-gather to the replicated tensor; backward the slice
  all_to_all    row j of a (n, ...) tensor to rank j; backward the
                reverse all-to-all (the expert-parallel MoE's dispatch,
                return and metadata exchanges, ``models/moe.py``)

Per block and connection mode the structure is the paper's Fig 2 (preln /
falplus two all-reduces, fal / parallel one, fal's block 0 the one extra
that exports the signal: (L+1)/(2L) of preln's bytes over L layers); under
sequence parallelism each all-reduce becomes a reduce-scatter at 1/tp the
bytes, behind an all-gather (``models/blocks.py``).

Under ``plan.grad_compress`` (``int8`` / ``lowrank``) the backward
all-reduce of ``enter`` and the backward all-gather of ``scatter_seq`` run
``optim/grad_compress.py``'s lossy exchanges; every forward collective
stays exact.  (The reference compresses the transpose of each forward
psum instead: the same count a block, other tensors; ROADMAP.md Queue 3.)

Every collective counts its calls, output bytes and ring-model wire bytes
by kind (all-reduce, all-reduce-max, reduce-scatter, all-gather,
all-to-all) and direction
(forward, backward; ``step`` for the train step's TP gradient and norm
sums; ``data`` for its one data-parallel gradient sum, ``metric`` for the
data-parallel mean of the loss; ``checkpoint`` for gathering a sharded
state; ``fsdp`` for FSDP's per-unit all-gathers and their backward
reduce-scatters, ``gather_fsdp``; ``seq`` for the decode tick's
partial-softmax combine over a sequence-cut cache, a MAX and a SUM
all-reduce a cutting group a layer and, over a model cut, the query
heads' all-gather, ``models/attention.py::seq_combine``):
``collective_counts()``,
``reset_collectives()``.  These replace
the reference's HLO parsers (``collective_payload_bytes``'s ring model).

Backends: ``init_tp_group(backend, ...)`` takes ``nccl`` or ``gloo`` and
picks neither on its own; ``nccl`` with fewer visible cards than ranks
raises.  Under ``gloo`` CUDA tensors are staged through host memory, decided
by the backend's name.  ``init_groups`` / ``split_groups`` cut one world
into tensor-parallel and data-parallel groups (TP the inner axis).
``run_ranks`` spawns one process per rank on one machine (a ``file://``
rendezvous, no port) and fails if any rank fails.
"""
from __future__ import annotations

import collections
import copy
import datetime
import importlib
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

#: {kind: {direction: {"calls": n, "bytes": b, "wire": w}}} since
#: reset_collectives()
_COUNTS: dict = {}


def collective_counts() -> dict:
    """{kind: {direction: {"calls", "bytes", "wire"}}} since the last
    ``reset_collectives()``.  ``bytes`` are each collective's output on this
    rank (the reduced shard for a reduce-scatter, the gathered tensor for an
    all-gather); ``wire`` the bytes a rank sends under a ring model, as the
    reference's ``core/tp.py::collective_payload_bytes`` bills them:
    all-reduce 2 out (n-1)/n, all-gather and all-to-all out (n-1)/n,
    reduce-scatter out (n-1)."""
    return copy.deepcopy(_COUNTS)


def reset_collectives():
    _COUNTS.clear()


def count(counts, kind, direction="forward", what="calls") -> int:
    """One number out of a ``collective_counts()`` dict (0 when absent)."""
    return counts.get(kind, {}).get(direction, {}).get(what, 0)


_WIRE = {"all-reduce": lambda b, n: 2 * b * (n - 1) // n,
         "all-reduce-max": lambda b, n: 2 * b * (n - 1) // n,
         "all-gather": lambda b, n: b * (n - 1) // n,
         "all-to-all": lambda b, n: b * (n - 1) // n,
         "reduce-scatter": lambda b, n: b * (n - 1)}


def _record(kind, direction, t, group):
    c = _COUNTS.setdefault(kind, {}).setdefault(
        direction, {"calls": 0, "bytes": 0, "wire": 0})
    b = t.numel() * t.element_size()
    c["calls"] += 1
    c["bytes"] += b
    c["wire"] += _WIRE[kind](b, group.size())


def _staged(t, group) -> bool:
    """gloo moves CUDA tensors through host memory: the backend's name
    decides, never a caught error."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


_REDUCE_OPS = {"all-reduce": dist.ReduceOp.SUM,
               "all-reduce-max": dist.ReduceOp.MAX}


def all_reduce(t, group, direction, kind="all-reduce"):
    """The sum of ``t`` over ``group`` (a new tensor), counted; with
    ``kind="all-reduce-max"`` the elementwise max, counted under that kind
    so that the sum all-reduces of the blocks' structure keep their counts
    (the serving ticks' quantized pages reduce each token row's K / V amax
    with it, one a layer a tick)."""
    stage = _staged(t, group)
    out = t.detach().to("cpu", copy=True) if stage \
        else t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_REDUCE_OPS[kind], group=group)
    _record(kind, direction, out, group)
    return out.to(t.device) if stage else out


def exchange_rows(t, group, direction):
    """All-to-all of a (n, ...) tensor over the n ranks of ``group``: row j
    goes to rank j, and row i of the result came from rank i."""
    stage = _staged(t, group)
    src = t.detach().to("cpu") if stage else t.detach()
    src = src.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _record("all-to-all", direction, out, group)
    return out.to(t.device) if stage else out


def gather_rows(t, group, direction, host=False):
    """All-gather: (...) on each rank -> (n, ...), row i rank i's; on
    ``t``'s device, or in host memory with ``host``."""
    stage = _staged(t, group)
    src = t.detach().to("cpu") if stage else t.detach()
    src = src.contiguous().reshape(-1)
    out = src.new_empty((group.size() * src.numel(),))
    dist.all_gather_into_tensor(out, src, group=group)
    _record("all-gather", direction, out, group)
    out = out.reshape((group.size(),) + tuple(t.shape))
    return out.cpu() if host else out.to(t.device)


def seq_collective(t, group, direction, gather):
    """All-gather (``gather``, tiled) or reduce-scatter of ``t`` along dim
    1, the sequence, through dim 0 of a (S, B, ...) copy."""
    n = dist.get_world_size(group)
    src = t.detach().movedim(1, 0).contiguous()
    stage = _staged(t, group)
    if stage:
        src = src.cpu()
    rows = src.shape[0] * n if gather else src.shape[0] // n
    out = src.new_empty((rows,) + tuple(src.shape[1:]))
    if gather:
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        dist.reduce_scatter_tensor(out, src, group=group)
    _record("all-gather" if gather else "reduce-scatter", direction, out,
            group)
    return out.to(t.device).movedim(0, 1).contiguous()


def _seq_slice(t, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    s = t.shape[1] // n
    return t.narrow(1, r * s, s).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange_rows(x, group, "forward")

    @staticmethod
    def backward(ctx, g):
        # row i of the output came from rank i, so its gradient goes back
        # to rank i: the same exchange
        return exchange_rows(g, ctx.group, "backward"), None


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, "forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, compress):
        ctx.group, ctx.compress = group, compress
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.compress == "none":
            return all_reduce(g, ctx.group, "backward"), None, None
        from repro_torch.optim import grad_compress as GC
        return GC.ALL_REDUCE[ctx.compress](g, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, compress):
        ctx.group, ctx.compress = group, compress
        return seq_collective(x, group, "forward", gather=False)

    @staticmethod
    def backward(ctx, g):
        if ctx.compress == "none":
            return (seq_collective(g, ctx.group, "backward", gather=True),
                    None, None)
        from repro_torch.optim import grad_compress as GC
        return GC.ALL_GATHER[ctx.compress](g, ctx.group), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return seq_collective(x, group, "forward", gather=True)

    @staticmethod
    def backward(ctx, g):
        return seq_collective(g, ctx.group, "backward", gather=False), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return seq_collective(g, ctx.group, "backward", gather=True), None


class _UnsplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return seq_collective(x, group, "forward", gather=True)

    @staticmethod
    def backward(ctx, g):
        return _seq_slice(g, ctx.group), None


def assemble(partial, group):
    """Sum a TP partial sum over ``group`` (*g*); identity without one."""
    return partial if group is None else _Assemble.apply(partial, group)


def all_to_all(x, group):
    """All-to-all of a (n, ...) tensor over the n ranks of ``group`` (row
    j to rank j; row i of the result from rank i), counted, with the
    reverse all-to-all as its backward."""
    return _AllToAll.apply(x, group)


def enter(x, group, compress="none"):
    """A replicated tensor entering sharded branches (*f*): its gradient,
    a partial sum on each rank, is all-reduced in the backward (by
    ``optim/grad_compress.py``'s ``compress`` exchange unless "none")."""
    return x if group is None else _Enter.apply(x, group, compress)


def scatter_seq(partial, group, compress="none"):
    """(B, S, ...) partial sums -> this rank's (B, S/tp, ...) shard of
    their sum (reduce-scatter; the backward all-gather by the ``compress``
    exchange unless "none")."""
    return _ScatterSeq.apply(partial, group, compress)


def gather_seq(shard, group):
    """(B, S/tp, ...) shards -> (B, S, ...) feeding sharded branches
    (all-gather; the backward reduce-scatters their partial gradients)."""
    return _GatherSeq.apply(shard, group)


def split_seq(x, group):
    """A replicated (B, S, ...) tensor -> this rank's (B, S/tp, ...)
    slice (no collective; the backward all-gathers)."""
    return _SplitSeq.apply(x, group)


def unsplit_seq(shard, group):
    """(B, S/tp, ...) shards -> the replicated (B, S, ...) tensor."""
    return _UnsplitSeq.apply(shard, group)


def all_reduce_(tensors, group, direction="step"):
    """Sum ``tensors`` (one dtype) over ``group`` in place, as ONE
    all-reduce of their concatenation: the train step's gradient sums
    (``step`` over the TP group, ``data`` over the data-parallel one).
    The concatenation is reduced in place: one copy of the tensors beside
    them on the device, none under gloo, where it is built in host memory
    straight from the tensors."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    if _staged(tensors[0], group):
        flat = torch.empty(sum(t.numel() for t in tensors),
                           dtype=tensors[0].dtype)
        i = 0
        for t in tensors:
            flat[i:i + t.numel()].copy_(t.reshape(-1))
            i += t.numel()
    else:
        flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    _record("all-reduce", direction, flat, group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


# ------------------------------------------------------------------------- #
# FSDP: a unit's slices gathered over the data group
# ------------------------------------------------------------------------- #
def _fsdp_collective(flat, group, gather):
    """All-gather of this rank's flat ``flat`` (total,) -> (n, total), or
    reduce-scatter of a (n, total) ``flat`` -> this rank's (total,) sum;
    counted under direction ``fsdp``.  Under gloo the one flat buffer is
    staged through host memory and the result comes back to the device:
    the device holds the same buffers as on a device backend."""
    stage = _staged(flat, group)
    src = flat.cpu() if stage else flat
    if gather:
        out = src.new_empty((group.size() * src.numel(),))
        dist.all_gather_into_tensor(out, src, group=group)
        out = out.view(group.size(), -1)
    else:
        out = src.new_empty((src.shape[1],))
        dist.reduce_scatter_tensor(out, src.reshape(-1), group=group)
    _record("all-gather" if gather else "reduce-scatter", "fsdp", out, group)
    return out.to(flat.device) if stage else out


class _GatherFsdp(torch.autograd.Function):
    """A unit's FSDP slices (one dtype) -> its whole leaves: ONE all-gather
    of their concatenation, each leaf joined along its dim and its padding
    dropped; backward: the leaves' gradients zero-padded, laid out rank by
    rank and reduce-scattered in ONE collective into the slices'
    gradients."""

    @staticmethod
    def forward(ctx, group, cuts, *slices):
        ctx.group, ctx.cuts = group, cuts
        ctx.shapes = [tuple(s.shape) for s in slices]
        n = group.size()
        out = _fsdp_collective(torch.cat([s.detach().reshape(-1)
                                          for s in slices]), group, True)
        fulls, off = [], 0
        for s, (dim, size) in zip(ctx.shapes, cuts):
            k = int(torch.Size(s).numel())
            part = out[:, off:off + k].reshape((n,) + s)
            off += k
            rows = s[:dim] + (n * s[dim],) + s[dim + 1:]
            fulls.append(part.movedim(0, dim).reshape(rows).narrow(
                dim, 0, size))
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.group.size()
        total = sum(int(torch.Size(s).numel()) for s in ctx.shapes)
        flat = grads[0].new_empty((n, total))
        off = 0
        for g, s, (dim, size) in zip(grads, ctx.shapes, ctx.cuts):
            k = int(torch.Size(s).numel())
            if size < n * s[dim]:
                pad = list(s)
                pad[dim] = n * s[dim] - size
                g = torch.cat([g, g.new_zeros(pad)], dim)
            g = g.reshape(s[:dim] + (n, s[dim]) + s[dim + 1:]).movedim(dim, 0)
            flat[:, off:off + k].view((n,) + s).copy_(g)
            off += k
        out = _fsdp_collective(flat, ctx.group, False)
        del flat
        grads_in, off = [], 0
        for s in ctx.shapes:
            k = int(torch.Size(s).numel())
            grads_in.append(out[off:off + k].view(s))
            off += k
        return (None, None) + tuple(grads_in)


def gather_fsdp(tree, cuts, group):
    """``tree`` (one unit's params: a block, the head) with the FSDP
    slices at ``cuts`` ({path in ``tree``: (dim, n)}, ``launch.mesh.
    fsdp_cuts``) replaced by the whole leaves, gathered over the data
    ``group``: one all-gather a unit (one a dtype, should a unit mix
    them), whose backward reduce-scatters the leaves' gradients into the
    slices' ``.grad``, once a backward pass.  Inside ``_maybe_remat`` the
    recompute gathers again and only the slices are saved.  The other
    leaves are as given."""
    from repro_torch.optim.adamw import map_tree, named_leaves
    paths = [(p, t) for p, t in named_leaves(tree) if p in cuts]
    if not paths:
        return tree
    out = map_tree(lambda t: t, tree)
    for dtype in dict.fromkeys(t.dtype for _, t in paths):
        mine = [(p, t) for p, t in paths if t.dtype == dtype]
        fulls = _GatherFsdp.apply(group, tuple(cuts[p] for p, _ in mine),
                                  *[t for _, t in mine])
        for (p, _), full in zip(mine, fulls):
            node = out
            for k in p[:-1]:
                node = node[k]
            node[p[-1]] = full
    return out


# ------------------------------------------------------------------------- #
# process groups and ranks
# ------------------------------------------------------------------------- #
BACKENDS = ("nccl", "gloo")


def init_tp_group(backend, *, rank, world_size, init_method="env://",
                  timeout_s=600):
    """Join the default process group and return it.  ``backend`` is
    required: ``nccl`` needs one visible card per rank (NCCL refuses two
    ranks on one card) and raises otherwise; ``gloo`` runs anywhere,
    staging CUDA tensors through host memory."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world_size:
            raise RuntimeError(
                f"nccl: {world_size} ranks but {n} visible CUDA devices; "
                f"NCCL needs one card per rank (pass backend='gloo' to run "
                f"ranks that share a card, through host memory)")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


#: a rank's two groups: ``tp`` the tensor-parallel one, ``dp`` the
#: data-parallel one (None where the axis has one rank)
Groups = collections.namedtuple("Groups", "tp dp")


def split_groups(tp_size) -> Groups:
    """Cut the default group's world into tensor-parallel groups of
    ``tp_size`` consecutive ranks and data-parallel groups across them: TP
    is the inner axis, ``rank = dp_rank * tp_size + tp_rank``, as Megatron
    and the reference's ``("data", "model")`` mesh order it.  Every rank
    makes every ``new_group`` call, in the same order.  An axis of one rank
    gets None; an axis spanning the world gets the default group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp_size < 1 or world % tp_size:
        raise ValueError(f"world size {world} is not a multiple of the TP "
                         f"size {tp_size}")
    dp_size = world // tp_size
    if dp_size == 1 or tp_size == 1:
        whole = dist.group.WORLD if world > 1 else None
        return Groups(tp=whole if dp_size == 1 else None,
                      dp=whole if tp_size == 1 else None)
    tp_group = dp_group = None
    for d in range(dp_size):
        g = dist.new_group(list(range(d * tp_size, (d + 1) * tp_size)))
        if rank // tp_size == d:
            tp_group = g
    for t in range(tp_size):
        g = dist.new_group(list(range(t, world, tp_size)))
        if rank % tp_size == t:
            dp_group = g
    return Groups(tp=tp_group, dp=dp_group)


def init_groups(backend, *, rank, world_size, tp_size,
                init_method="env://", timeout_s=600) -> Groups:
    """``init_tp_group`` over the whole world, then ``split_groups``."""
    init_tp_group(backend, rank=rank, world_size=world_size,
                  init_method=init_method, timeout_s=timeout_s)
    return split_groups(tp_size)


def spawn(argv, world_size, *, workdir, timeout=900, threads=None,
          env=None):
    """Run ``argv`` once per rank on this machine with ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` set (torchrun's variables), and
    ``TP_INIT_METHOD`` a ``file://`` rendezvous in ``workdir``.  Waits for
    all; if one fails or the time runs out, kills the others and raises
    with the logs' tails.  Returns each rank's output (stdout and stderr)."""
    os.makedirs(workdir, exist_ok=True)
    init = f"file://{os.path.abspath(workdir)}/rendezvous"
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    # ranks on one machine meet over the loopback interface
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        base["OMP_NUM_THREADS"] = str(threads)
        base["TP_THREADS"] = str(threads)
    procs, logs = [], []
    try:
        for r in range(world_size):
            log = os.path.join(workdir, f"rank{r}.log")
            logs.append(log)
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    argv, stdout=f, stderr=subprocess.STDOUT,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r),
                             WORLD_SIZE=str(world_size),
                             TP_INIT_METHOD=init)))
        t_end = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > t_end:
                raise RuntimeError(_failure(procs, logs, bad, timeout))
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(_failure(procs, logs, bad, timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for log in logs:
        with open(log) as f:
            out.append(f.read())
    return out


def _failure(procs, logs, bad, timeout):
    what = (f"rank(s) {bad} failed" if bad
            else f"ranks did not finish within {timeout} s")
    tails = []
    for r, log in enumerate(logs):
        with open(log) as f:
            tails.append(f"--- rank {r} (exit {procs[r].poll()}):\n"
                         + f.read()[-3000:])
    return what + "\n" + "\n".join(tails)


def run_ranks(target, world_size, *, backend, args=(), workdir=None,
              timeout=900, threads=None, tp_size=None):
    """Call ``target`` ("module:function") as ``fn(group, *args)`` in
    ``world_size`` spawned processes joined by ``init_tp_group(backend)``;
    return the list of their return values (by rank).  With ``tp_size``
    the world is cut by ``split_groups(tp_size)`` and ``group`` is the
    rank's ``Groups(tp, dp)``.  ``args`` cross with ``torch.save``; so do
    the results, in ``workdir`` (None: a temporary directory, removed
    afterwards).  Any rank failing fails the call."""
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="tp_ranks_") as tmp:
            return run_ranks(target, world_size, backend=backend, args=args,
                             workdir=tmp, timeout=timeout, threads=threads,
                             tp_size=tp_size)
    os.makedirs(workdir, exist_ok=True)
    torch.save(tuple(args), os.path.join(workdir, "args.pt"))
    env = {"TP_TARGET": target, "TP_BACKEND": backend, "TP_WORKDIR": workdir}
    if tp_size is not None:
        env["TP_SIZE"] = str(tp_size)
    spawn([sys.executable, "-c",
           "from repro_torch.core.tp import _rank_main; _rank_main()"],
          world_size, workdir=workdir, timeout=timeout, threads=threads,
          env=env)
    return [torch.load(os.path.join(workdir, f"result{r}.pt"),
                       weights_only=False) for r in range(world_size)]


def _rank_main():
    env = os.environ
    if env.get("TP_THREADS"):
        torch.set_num_threads(int(env["TP_THREADS"]))
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    group = init_tp_group(env["TP_BACKEND"], rank=rank, world_size=world,
                          init_method=env["TP_INIT_METHOD"])
    if env.get("TP_SIZE"):
        group = split_groups(int(env["TP_SIZE"]))
    mod, name = env["TP_TARGET"].split(":")
    fn = getattr(importlib.import_module(mod), name)
    args = torch.load(os.path.join(env["TP_WORKDIR"], "args.pt"),
                      weights_only=False)
    out = fn(group, *args)
    torch.save(out, os.path.join(env["TP_WORKDIR"], f"result{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------------- #
# structural harnesses (reference tp.py:40-192)
# ------------------------------------------------------------------------- #
def bench_stack_config(n_layers, d, d_ff, n_heads, mode):
    """A minimal dense config for TP structure tests."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        arch_id="tp-bench", family="dense", n_layers=n_layers, d_model=d,
        n_heads=n_heads, n_kv_heads=n_heads, d_ff=d_ff, vocab=256,
        connection=mode, norm="layernorm", mlp="gelu", dtype="float32",
        param_dtype="float32", remat=False, attn_block_q=64)


def _block_stack(cfg, seed, device, dtype):
    from repro_torch.models import blocks as BL
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"block0": BL.block_init(gen, cfg, dtype, device, is_block0=True),
            "blocks": [BL.block_init(gen, cfg, dtype, device)
                       for _ in range(cfg.n_layers - 1)]}


def make_tp_forward(group, n_layers, d, d_ff, n_heads, mode, *, sp=False,
                    device="cpu", grad_compress="none"):
    """(init_fn, forward) for an ``n_layers`` block stack under explicit TP
    over ``group``: ``init_fn(seed)`` draws the whole stack (the same on
    every rank) and returns this rank's shard; ``forward(params, x)`` runs
    ``models/model.py::decoder_stack_tp`` on the replicated x (B, S, d) and
    returns the replicated output.  ``sp=True``: the sequence-parallel
    layout; ``grad_compress``: the backward exchanges (none / int8 /
    lowrank)."""
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.launch import mesh as MX
    from repro_torch.models import model as M

    cfg = bench_stack_config(n_layers, d, d_ff, n_heads, mode)
    plan = ExecutionPlan.from_group(group, tp="explicit", sp=sp,
                                    grad_compress=grad_compress
                                    ).validate(cfg)

    def init_fn(seed):
        full = _block_stack(cfg, seed, device, torch.float32)
        return MX.shard_params(full, cfg, plan.tp_rank, plan.tp_size)

    def fwd(params, x):
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        return M.decoder_stack_tp(params, cfg, x, positions, plan)[0]

    return init_fn, fwd


def make_tp_decode_step(group, cfg, *, dual=False, page_size=8,
                        num_pages=9, device="cpu", dtype=None):
    """(init_fn, step) for ONE steady-state block's padded paged decode tick
    under explicit TP: ``init_fn(seed)`` -> (this rank's block shard, its
    cache with ``Hkv / tp`` KV heads a page); ``step(params, x (B, 1, d),
    cache, block_tables (B, T), pos (B,), n_valid (B,), a1_sig (B, 1, d))
    -> (x_out, cache)`` (cache updated in place).  ``dual``: the MHA || MLP
    dispatch, which merges both partial sums before the block's one
    all-reduce.  The block runs the model's TP block path (``block_apply``
    on ``plan.inner()``, which the serving ticks of ``models/model.py``
    run on every block) over a pool of ``local_kv_heads``, as
    ``init_paged_cache(..., tp_size=)`` builds a layer's."""
    from repro_torch.core.plan import ExecutionPlan, Phase, local_kv_heads
    from repro_torch.launch import mesh as MX
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as BL

    plan = ExecutionPlan.from_group(group, tp="explicit", phase=Phase.PAGED,
                                    dual_branch=dual).validate(cfg)
    inner = plan.inner()
    dt = getattr(torch, dtype or cfg.dtype)

    def init_fn(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        full = BL.block_init(gen, cfg, dt, device)
        params = MX.shard_params(full, cfg, plan.tp_rank, plan.tp_size)
        cache = A.gqa_init_paged_cache(
            cfg, num_pages, page_size, dt, device,
            n_kv_heads=local_kv_heads(cfg, plan.tp_size))
        return params, cache

    def step(params, x, cache, bt, pos, n_valid, a1_sig):
        out = BL.block_apply(params, cfg, x, a1_sig, plan=inner,
                             cache=cache, block_tables=bt, pos=pos,
                             n_valid=n_valid)[0]
        return out, cache

    return init_fn, step


def assert_dual_no_extra_collectives(group, modes=("fal", "parallel"), *,
                                     check_numeric=True, device="cpu"):
    """The dual-branch structural gate: per mode, one steady-state block's
    paged decode tick with and without ``dual`` (``make_tp_decode_step``,
    the same weights and cache contents) pays exactly ONE all-reduce either
    way, and (``check_numeric``) the outputs agree within 1e-5.  Returns
    {mode: {"sequential": counts, "dual": counts}}."""
    B, T, page, d = 2, 4, 8, 64
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((B, 1, d), generator=gen).to(device)
    sig = torch.randn((B, 1, d), generator=gen).to(device)
    bt = torch.arange(1, 1 + B * T, dtype=torch.int32).reshape(B, T)
    bt = bt.to(device)
    pos = torch.zeros((B,), dtype=torch.int32, device=device)
    nv = torch.ones((B,), dtype=torch.int32, device=device)
    result = {}
    for mode in modes:
        cfg = bench_stack_config(1, d, 128, 4, mode)
        counts, outs = {}, {}
        for dual in (False, True):
            init_fn, step = make_tp_decode_step(group, cfg, dual=dual,
                                                page_size=page,
                                                device=device)
            params, cache = init_fn(0)
            reset_collectives()
            with torch.no_grad():
                outs[dual], _ = step(params, x, cache, bt, pos, nv, sig)
            counts["dual" if dual else "sequential"] = collective_counts()
        seq = counts["sequential"]
        assert count(seq, "all-reduce") == 1, (mode, counts)
        assert counts["dual"] == seq, (mode, counts)
        if check_numeric:
            err = float((outs[True] - outs[False]).abs().max())
            assert err < 1e-5, (mode, err)
        result[mode] = counts
    return result
