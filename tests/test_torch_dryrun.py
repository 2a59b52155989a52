"""The port's dry run (``repro_torch.launch.specs`` / ``dryrun``) against the
reference's (``repro.launch.specs`` / ``mesh``) on the CPU, and the
kernels' meta route (``kernels/meta.py``) against their CPU route.

* The dry-run policy (overrides, optimizer, microbatches, the skip matrix)
  equals the reference's for every arch and input shape.
* The full-width abstract train state equals ``jax.eval_shape`` of the
  reference's ``init_state`` in elements, and in elements per dtype except
  for deepseek-v3, whose divergences are named: under ``param_dtype =
  "bfloat16"`` the reference's matmul weights come out fp32 (numpy scale
  factors promote its bf16 normals: ``repro/models/layers.py:68-71``
  ``dense_init``, ``repro/models/moe.py:38-44``) and its norms bf16; the
  port keeps every matmul weight in bf16 and every norm in fp32.
* One rank's block elements at tp 2 / 4 / 8 / 16 equal the shard sizes the
  reference's ``param_specs(..., fsdp_axes=(), kv_replicated=...)`` implies,
  wherever the plan's divisibility check takes the config; the leaves the
  port replicates by design are named.
* Under the ``fake`` group, remat off, a full-width llama3.2-3b step at tp
  8 pays L + 1 forward all-reduces under fal and 2 L under preln.
* The meta route gives the CPU route's shapes and dtypes at all seven sites
  and records ``meta-shape``; the storage tracker is exact on a known
  chain; one full-size ``run_one`` reports OK, with FSDP on by default.
* Under FSDP a rank's argument bytes are exactly its padded slices, its
  whole leaves and its batch (an uneven dim at data 256 included); with
  ``fsdp=False`` three pairs give the replicated layout's bytes.
"""
import collections
import functools
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import base as RB  # noqa: E402
from repro.launch import mesh as RMX  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import step as RT  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core.plan import (EXPLICIT_TP_FAMILIES,  # noqa: E402
                                   ExecutionPlan, kv_replicated)
from repro_torch.core.tp import count as tp_count  # noqa: E402
from repro_torch.kernels import meta, ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402

TRAIN = TB.INPUT_SHAPES["train_4k"]
#: reference leaf keys that are fp32 under deepseek's bf16 param_dtype
#: (dense_init's and moe_init's numpy scales), and those bf16 there that
#: the port keeps in fp32 (the norms)
DEEPSEEK_REF_FP32 = {"w_dq", "w_dkv", "w_kr", "w_uq", "w_uk", "w_uv", "wo",
                     "wi", "wg", "router", "w"}
DEEPSEEK_REF_BF16_NORMS = {"scale"}
#: top-level leaves the reference shards over ``model`` and the port keeps
#: whole on every rank (``src/repro_torch/launch/mesh.py:17-20``): the
#: vocab-sharded embedding and the column-sharded head; the MTP head's
#: block runs outside the TP stack
PORT_REPLICATED = {"embed", "head", "mtp"}


def _dt(name):
    return str(name).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    cfg = RSP.dryrun_overrides(RB.get_config(arch),
                               RB.INPUT_SHAPES["train_4k"])
    st = jax.eval_shape(lambda: RT.init_state(jax.random.PRNGKey(0), cfg,
                                              RSP.opt_cfg_for(cfg)))
    return cfg, st


def _ref_leaves(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path), leaf


def _port_cfg(arch):
    return SP.dryrun_overrides(TB.get_config(arch), TRAIN)


# ------------------------------------------------------------------ policy --
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_policy_matches_reference(arch, monkeypatch):
    monkeypatch.delenv("REPRO_MICROBATCHES", raising=False)
    for name, shape in TB.INPUT_SHAPES.items():
        rshape = RB.INPUT_SHAPES[name]
        cfg = SP.dryrun_overrides(TB.get_config(arch), shape)
        rcfg = RSP.dryrun_overrides(RB.get_config(arch), rshape)
        assert cfg.__dict__ == rcfg.__dict__
        assert SP.opt_cfg_for(cfg).state_dtype == \
            RSP.opt_cfg_for(rcfg).state_dtype
        assert SP.opt_cfg_for(cfg).lr == RSP.opt_cfg_for(rcfg).lr
        assert TB.shape_applicable(cfg, shape) == \
            RB.shape_applicable(rcfg, rshape)
        for data in (16, 32, 64):
            mesh = types.SimpleNamespace(shape={"data": data, "model": 8},
                                         axis_names=("data", "model"))
            assert SP.num_microbatches(cfg, shape, data) == \
                RSP.num_microbatches(rcfg, rshape, mesh), (name, data)
    assert SP.num_microbatches(cfg, TRAIN, 32, override=3) == 3


# ------------------------------------------------------------ train state --
def _per_dtype(pairs):
    out = collections.Counter()
    for dtype, n in pairs:
        out[_dt(dtype)] += n
    return dict(out)


@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_abstract_state_matches_eval_shape(arch):
    rcfg, rst = _ref_state(arch)
    ref = {"params": rst["params"], "m": rst["opt"]["m"],
           "v": rst["opt"]["v"]}
    state, batch = SP.train_input_specs(_port_cfg(arch), TRAIN)
    port = {"params": state["params"], "m": state["opt"]["m"],
            "v": state["opt"]["v"]}
    assert all(t.device.type == "meta" for _, t in named_leaves(port))
    ref_n = _per_dtype((l.dtype, int(np.prod(l.shape)))
                       for _, l in _ref_leaves(ref))
    port_n = _per_dtype((t.dtype, t.numel()) for _, t in named_leaves(port))
    assert sum(ref_n.values()) == sum(port_n.values())
    assert batch["tokens"].shape == (TRAIN.global_batch, TRAIN.seq_len)
    if not arch.startswith("deepseek"):
        assert ref_n == port_n
        ref_b = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                    for _, l in _ref_leaves(ref))
        port_b = sum(t.numel() * t.element_size()
                     for _, t in named_leaves(port))
        assert ref_b == port_b
        return
    # deepseek: the reference's params off param_dtype, by leaf key
    off = {}
    for path, l in _ref_leaves(rst["params"]):
        if _dt(l.dtype) != rcfg.param_dtype:
            off.setdefault(_dt(l.dtype), set()).add(path[-1])
    assert off == {"float32": DEEPSEEK_REF_FP32}
    ref_norms = sum(int(np.prod(l.shape)) for p, l in
                    _ref_leaves(rst["params"])
                    if p[-1] in DEEPSEEK_REF_BF16_NORMS)
    port_fp32 = {p[-1] for p, t in named_leaves(state["params"])
                 if t.dtype == torch.float32}
    assert port_fp32 == DEEPSEEK_REF_BF16_NORMS
    ref_fp32 = ref_n["float32"]
    # every reference fp32 element is a bf16 matmul weight in the port, and
    # every port fp32 element a norm the reference holds in bf16
    assert port_n["float32"] == ref_norms
    assert port_n["bfloat16"] - ref_n["bfloat16"] == ref_fp32 - ref_norms


# -------------------------------------------------------------- TP shards --
def _divides(cfg, tp_size):
    group = types.SimpleNamespace(size=lambda: tp_size, rank=lambda: 0)
    try:
        ExecutionPlan.from_group(group, tp="explicit").validate(cfg)
    except ValueError:
        return False
    return True


def _in_blocks(path):
    """Whether a leaf (by path, either package's tree) sits in the blocks
    explicit TP cuts or keeps whole by rule: the decoder's, whisper's
    encoder and decoder stacks, zamba2's shared block and mamba2's
    layers (``launch/mesh.py::BLOCK_KEYS``; reference ``blocks_dense`` /
    ``blocks_moe`` / ``blocks``)."""
    return path[0].startswith("block") or path[0] in MX.BLOCK_KEYS


@pytest.mark.parametrize(
    "arch", [a for a in TB.ARCH_IDS
             if TB.get_config(a).family in EXPLICIT_TP_FAMILIES])
def test_tp_shard_elements_match_param_specs(arch):
    cfg = _port_cfg(arch)
    rcfg, rst = _ref_state(arch)
    full = TM.init_params(cfg, device="meta", dtype=cfg.param_dtype)
    checked = 0
    for tp_size in (2, 4, 8, 16):
        if not _divides(cfg, tp_size):
            continue
        checked += 1
        kv_rep = kv_replicated(cfg, tp_size)
        specs = jax.tree_util.tree_leaves(
            RMX.param_specs(rst["params"], rcfg, fsdp_axes=(),
                            kv_replicated=kv_rep),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        ref_blocks, ref_sharded_out = 0, set()
        for (path, leaf), spec in zip(_ref_leaves(rst["params"]), specs):
            n = int(np.prod(leaf.shape))
            split = RMX.MODEL in tuple(spec)
            if _in_blocks(path):
                ref_blocks += n // tp_size if split else n
            elif split:
                ref_sharded_out.add(path[0])
        shard = MX.shard_params(full, cfg, 0, tp_size, kv_rep)
        port_blocks = sum(t.numel() for p, t in named_leaves(shard)
                          if _in_blocks(p))
        assert port_blocks == ref_blocks, (arch, tp_size)
        assert ref_sharded_out <= PORT_REPLICATED
        outside = [t for p, t in named_leaves(shard) if not _in_blocks(p)]
        assert all(any(t is u for _, u in named_leaves(full))
                   for t in outside)            # replicated: the same tensor
    if arch in ("llama3.2-3b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
                "mamba2-370m", "zamba2-1.2b"):
        assert checked >= 3
    if arch == "whisper-small":
        assert checked == 2                      # 12 heads: tp 2 and 4


# ------------------------------------------------------------ collectives --
@pytest.mark.parametrize("mode, per_block, extra", [("fal", 1, 1),
                                                   ("preln", 2, 0)])
def test_fake_group_all_reduce_counts(mode, per_block, extra):
    """fal: one all-reduce a block plus block 0's export of the signal;
    preln: two a block (PERF.md's 5 / 8 at 4 layers)."""
    shape = TB.ShapeConfig("short", 128, 1, "train")
    info = D.lower_pair("llama3.2-3b", shape, D.Mesh(1, 1, 8),
                        connection=mode, extra_overrides={"remat": False})
    L = TB.get_config("llama3.2-3b").n_layers
    want = per_block * L + extra
    ar = info["collectives"]["all-reduce"]
    assert ar["forward"]["calls"] == want
    assert ar["backward"]["calls"] == want
    assert info["dispatch_paths"] == {"flash_attention": ops.META,
                                      "fused_ln_add": ops.META} \
        if mode == "fal" else {"flash_attention": ops.META}
    assert not dist.is_initialized()


# -------------------------------------------------------------- meta route --
def _site_cases(device):
    """Each site's call on small inputs on ``device`` (made on the CPU from
    one seed, then moved)."""
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g).to(device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32).to(device)
    B, T, H, Hkv, D_, P, page = 2, 5, 4, 2, 32, 9, 4
    kp, vp = r(P, page, Hkv, D_), r(P, page, Hkv, D_)
    bt = i32([[1, 2], [3, 4]])
    ffn = {"wi": r(64, 128), "wg": r(64, 128), "wo": r(128, 64)}
    return {
        "flash_attention": lambda: ops.flash_attention(
            r(B, 8, H, D_), r(B, 8, Hkv, D_), r(B, 8, Hkv, D_)),
        "fused_ln_add": lambda: ops.fused_ln_add(
            r(B, 8, 64), r(B, 8, 64), torch.ones(64).to(device)),
        "paged_packed_attention": lambda: ops.paged_packed_attention(
            r(T, H, D_), kp, vp, bt, i32([0, 0, 1, 1, 0]),
            i32([0, 1, 0, 1, -1])),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            r(B, H, D_), kp, vp, bt, i32([3, 8])),
        "paged_chunk_attention": lambda: ops.paged_chunk_attention(
            r(B, 3, H, D_), kp, vp, bt, i32([0, 4]), i32([3, 2])),
        "dual_branch_decode": lambda: ops.dual_branch_decode(
            r(B, H, D_), kp, vp, bt, i32([3, 8]), r(B, 1, 64), ffn),
        "copy_pages": lambda: ops.copy_pages(kp, [1], [5]),
    }


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), out.dtype)]
    return [s for t in out for s in _shapes(t)]


SITES = ("flash_attention", "fused_ln_add", "paged_packed_attention",
         "paged_decode_attention", "paged_chunk_attention",
         "dual_branch_decode", "copy_pages")


@pytest.mark.parametrize("site", SITES)
def test_meta_route_matches_cpu_shapes(site):
    ops.reset_dispatch_paths()
    cpu = _site_cases("cpu")[site]()
    assert ops.dispatch_paths() == {site: ops.PLAIN}
    ops.reset_dispatch_paths()
    ops.reset_meta_counts()
    ops.reset_launches()
    out = _site_cases("meta")[site]()
    assert ops.dispatch_paths() == {site: ops.META}
    assert _shapes(out) == _shapes(cpu)
    assert all(t.device.type == "meta" for t in
               ([out] if isinstance(out, torch.Tensor) else out))
    counts = ops.meta_counts()
    assert counts and all(c["calls"] == 1 and c["bytes"] > 0
                          for c in counts.values())
    assert sum(ops.launch_counts().values()) == 0
    if site in ("fused_ln_add", "copy_pages"):
        assert all(c["flops"] == 0 for c in counts.values())


def test_meta_flash_flops_and_backward():
    q = torch.empty((2, 64, 4, 32), device="meta", requires_grad=True)
    k = torch.empty((2, 64, 2, 32), device="meta", requires_grad=True)
    ops.reset_meta_counts()
    o = ops.flash_attention(q, k, k, window=16)
    o.sum().backward()
    pairs = sum(min(i + 1, 16) for i in range(64))
    want = 4 * 32 * 2 * 4 * pairs
    counts = ops.meta_counts()
    assert counts["flash_attention"]["flops"] == want
    assert counts["flash_attention.bwd"]["flops"] == 2.5 * want
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    x = torch.empty((8, 64), device="meta", requires_grad=True)
    scale = torch.ones(64, device="meta", requires_grad=True)
    ops.fused_ln_add(x, x, scale).sum().backward()
    assert meta.counts()["fused_ln_add.bwd"]["calls"] == 1
    assert x.grad.shape == x.shape and scale.grad.dtype == torch.float32


# ---------------------------------------------------------------- tracker --
def test_storage_tracker_is_exact_on_a_chain():
    tr = D.StorageTracker()
    a = torch.empty(1000, device="meta")                # 4000 bytes
    assert tr.track({"a": a, "view": a[:10]}) == 4000
    with tr:
        b = a * 2                                       # +4000: 8000
        c = b.view(10, 100).t()                         # a view: no bytes
        d = c + 1                                       # +4000: 12000
        d.add_(1)                                       # in place
        del b, c                                        # b's storage freed
        e = d.to(torch.bfloat16)                        # +2000: 10000
        s = e.sum()                                     # +2: 10002
    assert tr.peak == 12000
    assert tr.current == 4000 + 4000 + 2000 + 2
    del d
    assert tr.current == 6002
    assert s.shape == ()


def test_run_one_full_size_reports_ok(tmp_path):
    info = D.run_one("llama3.2-3b", "train_4k", "single",
                     out_dir=str(tmp_path))
    line = D.report("llama3.2-3b", "train_4k", "single", info)
    assert line.startswith("OK"), line
    assert info["tp"] == "explicit" and info["fsdp"] is True
    assert tp_count(info["collectives"], "reduce-scatter", "fsdp") > 0
    assert info["mesh"] == {"pod": 1, "data": 32, "model": 8}
    mem = info["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert info["cost"]["flops"] > info["cost"]["kernel_flops"] > 0
    assert (tmp_path / "llama3.2-3b_train_4k_single.json").exists()
    assert not dist.is_initialized()
    off = D.lower_pair("llama3.2-3b", "decode_32k", D.MESHES["single"],
                       fsdp=False)
    assert off["fsdp"] is False and "all-gather" not in off["collectives"]


# -------------------------------------------------------------------- FSDP --
def _expected_arguments(cfg, mesh, rows, seq):
    """A train pair's argument bytes under FSDP, from the layout alone: each
    leaf of the rank's TP shard, an FSDP leaf at ceil(n / dp) rows along
    its dim, in the params' dtype and twice in the moments', plus the
    int32 tokens."""
    dp, tp_size = mesh.pod * mesh.data, mesh.model
    full = TM.init_params(cfg, device="meta", dtype=cfg.param_dtype)
    if tp_size > 1:
        full = MX.shard_params(full, cfg, 0, tp_size)
    layout = MX.fsdp_layout(cfg, tp_size, dp)
    moment = torch.empty((), dtype=getattr(
        torch, SP.opt_cfg_for(cfg).state_dtype)).element_size()
    total = rows * seq * 4
    for path, t in named_leaves(full):
        n = t.numel()
        if path in layout:
            dim, size = layout[path]
            n = n // size * MX.fsdp_rows(size, dp)
        total += n * (t.element_size() + 2 * moment)
    return total


@pytest.mark.parametrize("arch,mesh", [("llama3.2-3b", D.Mesh(1, 32, 8)),
                                       ("qwen3-moe-30b-a3b", D.Mesh(2, 32, 8)),
                                       ("mamba2-370m", D.Mesh(1, 256, 1))])
def test_fsdp_argument_bytes_are_the_padded_slices(arch, mesh):
    """mamba2's in_proj output (4384) is uneven over 256 data ranks: every
    rank holds 18 of its rows, the last one zero-padded."""
    shape = TB.ShapeConfig("short", 128, 2 * mesh.pod * mesh.data, "train")
    info = D.lower_pair(arch, shape, mesh, microbatches=1)
    cfg = SP.dryrun_overrides(TB.get_config(arch), shape)
    want = _expected_arguments(cfg, mesh, info["rows"], 128)
    assert info["fsdp"] is True
    assert info["memory"]["argument_bytes"] == want
    off = D.lower_pair(arch, shape, mesh, microbatches=1, fsdp=False)
    assert off["memory"]["argument_bytes"] > want
    c = info["collectives"]
    assert tp_count(c, "all-gather", "fsdp") > 0
    assert tp_count(c, "reduce-scatter", "fsdp") > 0
    if arch == "mamba2-370m":
        dim, n = MX.fsdp_layout(cfg, 1, 256)[("blocks", 0, "mixer",
                                              "in_proj")]
        assert (dim, n, MX.fsdp_rows(n, 256)) == (1, 4384, 18)


#: argument bytes of three pairs with the params replicated over the data
#: axes, as the dry run reported them before it had FSDP.  zamba2-1.2b's
#: long_500k on the multi mesh (then 512 data ranks x model 1, batch 1)
#: held 30,431,698,952 B, the shared block's whole K / V among them: 6
#: invocations x 2 x 524288 x 32 heads x 64 x 2 bytes = 25,769,803,776 B.
#: Its mesh is now pod 2 x data 32 x model 8.  The reference's
#: decode-cache layout (``cache_specs``) cuts that sequence over the 64
#: data ranks and the 32 heads over the 8 model ranks: a rank keeps 1 / 512
#: of it (its one row of mamba state stays whole).  And its ``param_specs``
#: cut the shared block's seven matmul weights over the model ranks (4 x
#: 2048 x 2048 attention, 3 x 2048 x 8192 FFN elements in fp32): a rank
#: keeps 1 / 8 of their 268,435,456 B, the mamba layers and the
#: top-level ``in_proj`` whole
ZAMBA_KV_BYTES = 6 * 2 * 524288 * 32 * 64 * 2
ZAMBA_SHARED_BYTES = (4 * 2048 * 2048 + 3 * 2048 * 8192) * 4
NO_FSDP_ARGUMENT_BYTES = {
    ("llava-next-mistral-7b", "prefill_32k", "single"): 4563042304,
    ("qwen3-4b", "decode_32k", "single"): 5789196320,
    ("zamba2-1.2b", "long_500k", "multi"):
        30431698952 - ZAMBA_KV_BYTES * 511 // 512
        - ZAMBA_SHARED_BYTES * 7 // 8}


@pytest.mark.parametrize("pair", NO_FSDP_ARGUMENT_BYTES)
def test_no_fsdp_keeps_the_replicated_layouts_bytes(pair):
    arch, shape, kind = pair
    info = D.run_one(arch, shape, kind, fsdp=False)
    assert info["fsdp"] is False
    assert info["memory"]["argument_bytes"] == NO_FSDP_ARGUMENT_BYTES[pair]
    on = D.run_one(arch, shape, kind)
    assert on["memory"]["argument_bytes"] < NO_FSDP_ARGUMENT_BYTES[pair]


# -------------------------------------------------- the decode cache layout --
def _ref_rank_bytes(cfg, shape_cfg, mesh):
    """One rank's decode-cache bytes by the reference's own arithmetic:
    ``repro.launch.mesh.cache_specs`` on a stand-in of the mesh (it reads
    only ``axis_names`` and ``shape``) over ``jax.eval_shape`` of its
    ``init_cache``, each dim divided by its axes' sizes."""
    names = ("pod", "data", "model") if mesh.pod > 1 else ("data", "model")
    sizes = {"pod": mesh.pod, "data": mesh.data, "model": mesh.model}
    stand = types.SimpleNamespace(axis_names=names,
                                  shape={a: sizes[a] for a in names})
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    rcfg = RSP.dryrun_overrides(RB.get_config(cfg.arch_id), shape_cfg)
    cache = jax.eval_shape(lambda: RM.init_cache(rcfg, B, S, "bfloat16"))
    specs = RMX.cache_specs(rcfg, stand, B)(cache)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(cache), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, RMX.P))):
        n = leaf.dtype.itemsize
        for d, e in zip(leaf.shape, spec):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                d //= stand.shape[a]
            n *= d
        total += n
    return total


DECODE_PAIRS = [(a, s, k) for a in TB.ARCH_IDS if not a.startswith("gpt2")
                for s in ("decode_32k", "long_500k")
                for k in ("single", "multi")
                if TB.shape_applicable(TB.get_config(a), TB.INPUT_SHAPES[s])[0]
                and TB.get_config(a).n_heads % D.production_mesh(
                    k, TB.get_config(a)).model == 0]


@pytest.mark.parametrize("arch", sorted({a for a, _, _ in DECODE_PAIRS}))
def test_decode_pairs_cache_bytes_match_reference_arithmetic(arch):
    """Every decode pair of the dry run (``specs.decode_input_specs`` at
    ``production_mesh``, rank 0): the cache bytes a rank equal the
    reference's layout's, and the tokens and positions are the whole
    batch where it does not divide the data ranks (the reference's
    ``bspec``), else the rank's rows."""
    for _, shape, kind in [p for p in DECODE_PAIRS if p[0] == arch]:
        shape_cfg = TB.INPUT_SHAPES[shape]
        cfg = SP.dryrun_overrides(TB.get_config(arch), shape_cfg)
        mesh = D.production_mesh(kind, cfg)
        dp = mesh.pod * mesh.data
        _, cache, tokens, pos = SP.decode_input_specs(cfg, shape_cfg,
                                                      mesh.model, dp,
                                                      fsdp=True)
        assert D.storage_bytes(cache) == _ref_rank_bytes(cfg, shape_cfg,
                                                         mesh), (shape, kind)
        B = shape_cfg.global_batch
        rows = B // dp if B % dp == 0 else B
        assert tokens.shape == (rows, 1) and pos.shape == (rows,)
