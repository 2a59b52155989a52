"""Dry run on the ``meta`` device: one rank's train step, prefill or decode
tick of every (arch x input shape x mesh), with the rank's memory, flops,
bytes and collectives counted.  Nothing is allocated and no card is
needed: seconds a pair on a CPU.

Port of ``repro/launch/dryrun.py`` (``lower_pair`` ``:38``, ``run_one``
``:125``, ``main`` ``:155``).  The reference lowers and compiles against
``ShapeDtypeStruct`` inputs on 512 forced host devices and reads XLA's
memory and cost analyses; here rank 0 of the mesh runs the port's own
entry points on ``meta`` tensors (``launch/specs.py``) inside a ``fake``
process group of the mesh's world size, in which every collective is
counted (``core/tp.py``) and moves nothing:

  train    one ``train.step.make_train_step`` step with
           ``specs.num_microbatches``, under the explicit-TP plan
  prefill  ``models.model.forward`` at ``Phase.PREFILL``, no gradients
  decode   one ``serve.decode.make_serve_step`` tick over the contiguous
           cache in the reference's layout (``launch/mesh.py::
           cache_specs``): the KV sequence cut over the data axes where
           the batch does not divide them and over the model axis where
           the KV heads do not (MLA's latent always); the partial-softmax
           combine's collectives count under direction ``seq``

Meshes: ``single`` is the reference's 256 cards and ``multi`` its 512, as
data 32 x model 8 and pod 2 x data 32 x model 8 (TP inside an 8-card
NVLink node; the reference's model 16 does not divide llama's 24 heads).
A hybrid or audio config whose heads model 8 does not divide takes the
largest power of two that does, the same cards over more data ranks
(whisper-small's 12 heads: data 64 x model 4); mamba2 takes model 8 with
its mixers whole on every model rank and its batch over the data axes
only (the reference's layout).  The port's TP is always explicit.  FSDP
over the data axes is on for every arch, as the reference's default
(MaxText's; ``--no-fsdp`` is the ablation): the rank holds its slices
(``launch/mesh.py::shard_fsdp``), each unit all-gathers them when it runs
and the train step's backward reduce-scatters their gradients (direction
``fsdp`` in ``collectives``).

Each pair's JSON holds the reference's fields and, all from the abstract
run, one rank's ``memory`` (``argument_bytes``: the state and batch, or
params, cache and tokens; ``output_bytes``; ``peak_bytes`` and
``temp_bytes`` from a live-storage tracker) and ``cost`` (``flops``:
``FlopCounterMode`` plus the kernels' meta counts, ``kernels/meta.py``;
``bytes``: each op's inputs plus outputs, as XLA's "bytes accessed"), and
``collectives`` (``tp.collective_counts()``, the counterpart of reading
the HLO) in place of a ``.hlo`` file; ``trace_s`` in place of
``compile_s``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import ast
import collections
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ShapeConfig,
                                      get_config, shape_applicable)
from repro_torch.core import tp
from repro_torch.core.plan import ExecutionPlan, Phase
from repro_torch.kernels import ops
from repro_torch.launch import mesh as MX
from repro_torch.launch import specs as SP
from repro_torch.models import model as M
from repro_torch.serve.decode import make_serve_step
from repro_torch.train import step as tstep

#: one mesh: the pod, data and model axes' sizes (world = their product)
Mesh = collections.namedtuple("Mesh", "pod data model")
MESHES = {"single": Mesh(1, 32, 8), "multi": Mesh(2, 32, 8)}
#: device memory of one card, the "fits" line of the report
CARD_BYTES = 80 * 10 ** 9
#: ops that allocate without reading or writing a byte
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}


def production_mesh(kind, cfg) -> Mesh:
    """The mesh of ``kind`` for ``cfg``: ``MESHES[kind]``; for the hybrid
    and audio families its model axis halved (and its data axis doubled)
    until it divides the heads.  mamba2 keeps model 8 (its mixers whole);
    a decoder whose heads model 8 does not divide is refused by its plan,
    as before."""
    m = MESHES[kind]
    model = m.model
    while cfg.family in ("hybrid", "audio") and cfg.n_heads % model:
        model //= 2
    return Mesh(m.pod, m.data * m.model // model, model)


def _world(mesh):
    return mesh.pod * mesh.data * mesh.model


@contextlib.contextmanager
def fake_world(world):
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0, destroyed on exit: collectives count and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dry run: a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class StorageTracker(TorchDispatchMode):
    """Live device bytes over a run of ``meta`` (or any) tensors: each
    storage counted once (views share one), from the op that makes it until
    it is freed (a weakref on the storage; a meta storage has no data
    pointer to key by), as ``torch.distributed._tools.mem_tracker`` keys
    them.  ``peak`` is the most bytes live at once; ``accessed`` the
    inputs plus outputs of every op that is not a view or an allocation."""

    def __init__(self):
        super().__init__()
        self._live = {}
        self.current = self.peak = self.accessed = 0

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live (the run's
        arguments); returns the bytes newly counted."""
        before = self.current
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage())
        return self.current - before

    def _add(self, st):
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def free(_, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.current -= n
        self._live[key] = weakref.ref(st, free)
        self.current += n
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_TRAFFIC:
            self.accessed += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage())
        return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _plans(cfg, mesh, sp, fsdp, decode_batch=None):
    """(train plan, serving plan) of rank 0: the explicit-TP plan over the
    model axis (train also over the data axes' group), or with model 1 no
    TP group.  With ``fsdp`` (and data ranks) both plans slice the params
    over the data group; the serving plan then carries it too.  For a
    decode pair (``decode_batch``, the global batch) the serving plan
    carries the reference's cache layout (``with_cache_layout``) and the
    data group whenever that layout cuts the KV sequence over it."""
    groups = tp.split_groups(mesh.model)
    tp_style = "explicit" if mesh.model > 1 else "none"
    fsdp = fsdp and groups.dp is not None
    train = ExecutionPlan.from_group(groups.tp, tp=tp_style, sp=sp,
                                     data_group=groups.dp,
                                     fsdp=fsdp).validate(cfg)
    cut = decode_batch is not None and "data" in MX.seq_axes(
        cfg, mesh.model, mesh.pod * mesh.data, decode_batch)
    serve = ExecutionPlan.from_group(groups.tp, tp=tp_style, sp=sp,
                                     data_group=groups.dp if fsdp or cut
                                     else None, fsdp=fsdp)
    if decode_batch is not None:
        serve = serve.with_cache_layout(cfg, decode_batch)
    return train, serve


def _shape_of(shape):
    return shape if isinstance(shape, ShapeConfig) else INPUT_SHAPES[shape]


def lower_pair(arch, shape, mesh, *, connection=None, fsdp=True,
               extra_overrides=None, sp=False, microbatches=None):
    """Run rank 0 of ``mesh`` (a ``Mesh``) through ``shape`` (a name of
    ``INPUT_SHAPES`` or a ``ShapeConfig``) on ``meta`` and return the info
    dict (``{"skipped": why}`` when the pair does not apply).  ``fsdp``:
    the params sliced over the data axes (the reference's default; with one
    data rank nothing is sliced); ``sp``: sequence-parallel LN regions
    (train / prefill); ``microbatches`` overrides ``num_microbatches``
    (the reference's ``REPRO_MICROBATCHES``); ``extra_overrides`` replace
    config fields."""
    shape_cfg = _shape_of(shape)
    cfg = SP.dryrun_overrides(get_config(arch), shape_cfg)
    if connection:
        cfg = cfg.replace(connection=connection)
    if extra_overrides:
        cfg = cfg.replace(**extra_overrides)
    ok, why = shape_applicable(cfg, shape_cfg)
    if not ok:
        return {"skipped": why}
    if sp and shape_cfg.mode == "decode":
        return {"skipped": "sequence-parallel LN regions are a full-sequence "
                           "(train/prefill) layout; decode ticks are 1-token"}
    dp = mesh.pod * mesh.data
    with fake_world(_world(mesh)):
        try:
            train_plan, serve_plan = _plans(
                cfg, mesh, sp, fsdp, shape_cfg.global_batch
                if shape_cfg.mode == "decode" else None)
        except ValueError as e:               # the plan's own refusal
            return {"skipped": f"{type(e).__name__}: {e}"}
        nmb = SP.num_microbatches(cfg, shape_cfg, dp, microbatches)
        sliced = train_plan.fsdp
        if sliced:
            # the layout table (a meta init, cached) is set-up, not the
            # step's memory: built here, it is warm for every mode, as a
            # train step's constructor leaves it
            MX.fsdp_layout(cfg, mesh.model, dp)
        if shape_cfg.mode == "train":
            args = SP.train_input_specs(cfg, shape_cfg, mesh.model, dp,
                                        fsdp=sliced)
            step = tstep.make_train_step(cfg, SP.opt_cfg_for(cfg),
                                         train_plan, nmb)
        elif shape_cfg.mode == "prefill":
            params, _, _, _ = SP.decode_input_specs(cfg, shape_cfg,
                                                    mesh.model, dp,
                                                    fsdp=sliced)
            args = (params, SP.batch_struct(cfg, shape_cfg, dp))
            step = _prefill(cfg, serve_plan.with_phase(Phase.PREFILL))
        else:
            args = SP.decode_input_specs(cfg, shape_cfg, mesh.model, dp,
                                         fsdp=sliced)
            step = make_serve_step(cfg, serve_plan)
        tracker = StorageTracker()
        arg_bytes = tracker.track(args)
        tp.reset_collectives()
        ops.reset_dispatch_paths()
        ops.reset_meta_counts()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc, tracker:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        kernels = ops.meta_counts()
        info = {
            "arch": arch, "shape": shape_cfg.name,
            "mesh": dict(mesh._asdict()), "connection": cfg.connection,
            "fsdp": bool(fsdp), "tp": "explicit" if mesh.model > 1 else "none",
            "sp": bool(sp), "trace_s": round(trace_s, 2),
            "rows": (SP.decode_rows if shape_cfg.mode == "decode"
                     else SP.batch_rows)(shape_cfg.global_batch, dp),
            "num_microbatches": nmb,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": storage_bytes(out),
                       "temp_bytes": tracker.peak - arg_bytes,
                       "peak_bytes": tracker.peak},
            "cost": {"flops": fc.get_total_flops()
                     + sum(k["flops"] for k in kernels.values()),
                     "kernel_flops": sum(k["flops"] for k in kernels.values()),
                     "bytes": tracker.accessed
                     + sum(k["bytes"] for k in kernels.values())},
            "collectives": tp.collective_counts(),
            "kernels": kernels, "dispatch_paths": ops.dispatch_paths(),
        }
    if cfg.family == "ssm" and mesh.model > 1:
        info["note"] = (f"mamba mixers whole on each of the {mesh.model} "
                        f"model ranks (the reference's layout): the batch "
                        f"is cut over the data axes only")
    return info


def _prefill(cfg, plan):
    @torch.no_grad()
    def prefill(params, batch):
        return M.forward(params, cfg, batch, plan)[0]
    return prefill


def run_one(arch, shape, mesh_kind, out_dir=None, connection=None,
            fsdp=True, extra_overrides=None, tag_suffix="", sp=False,
            microbatches=None):
    """``lower_pair`` on ``production_mesh(mesh_kind)``, errors caught into
    the info dict; writes ``<arch>_<shape>_<mesh>[...].json`` to
    ``out_dir`` for a pair that ran.  Returns the info dict."""
    cfg = get_config(arch)
    mesh = production_mesh(mesh_kind, cfg)
    try:
        info = lower_pair(arch, shape, mesh, connection=connection,
                          fsdp=fsdp, extra_overrides=extra_overrides, sp=sp,
                          microbatches=microbatches)
    except Exception as e:  # noqa: BLE001 - reported as FAIL
        info = {"arch": arch, "shape": shape, "mesh": dict(mesh._asdict()),
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    info["mesh_kind"] = mesh_kind
    if out_dir and "skipped" not in info and "error" not in info:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape}_{mesh_kind}"
        if connection:
            tag += f"_{connection}"
        if sp:
            tag += "_sp"
        if not fsdp:
            tag += "_nofsdp"
        if tag_suffix:
            tag += f"_{tag_suffix}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(info, f, indent=1)
    return info


def report(arch, shape, mesh_kind, info) -> str:
    """The pair's line: OK with one rank's numbers, SKIP with the reason,
    or FAIL with the error."""
    head = f"{arch:24s} {shape:12s} {mesh_kind}"
    if "skipped" in info:
        return f"SKIP  {head}: {info['skipped']}"
    if "error" in info:
        return f"FAIL  {head}: {info['error']}"
    mem, ar = info["memory"], info["collectives"].get("all-reduce", {})
    return (f"OK    {head} trace={info['trace_s']}s "
            f"args/rank={mem['argument_bytes'] / 2**30:.2f}GiB "
            f"peak/rank={mem['peak_bytes'] / 2**30:.2f}GiB "
            f"fits={mem['peak_bytes'] <= CARD_BYTES} "
            f"flops={info['cost']['flops']:.3g} "
            f"fwd all-reduces={ar.get('forward', {}).get('calls', 0)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--connection", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="params replicated over the data axes (the "
                         "ablation; FSDP is the default)")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel LN regions (activations sharded "
                         "over the model axis; reduce-scatter / all-gather "
                         "instead of all-reduce)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="microbatches of a train step (default: "
                         "specs.num_microbatches)")
    ap.add_argument("--out", default="experiments/torch_dryrun")
    ap.add_argument("--no-hlo", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "port writes no .hlo (the JSON holds the "
                         "collective counts)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.overrides:
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        overrides[k] = v

    archs = [a for a in ARCH_IDS if not a.startswith("gpt2")] \
        if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failed = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                info = run_one(arch, shape, mk, args.out,
                               connection=args.connection,
                               fsdp=not args.no_fsdp,
                               extra_overrides=overrides or None,
                               tag_suffix="_".join(
                                   f"{k}-{v}" for k, v in
                                   overrides.items())[:40],
                               sp=args.sp, microbatches=args.microbatches)
                failed += "error" in info
                print(report(arch, shape, mk, info), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
