"""The port's ``optim/grad_compress.py`` against the JAX package's, on the
CPU.

* The exchanges: ``_int8_allreduce``, ``_lowrank_allreduce``,
  ``_int8_allgather`` and ``_lowrank_allgather`` on two gloo ranks
  (``core.tp.run_ranks``) against the reference's under ``shard_map`` on a
  forced 2-device mesh (one subprocess, ``--xla_force_host_platform_
  device_count=2``, as ``tests/test_distributed.py`` runs its meshes),
  each rank on the same slice of the same numpy inputs.  int8: the codes
  and scales are the reference's (the operation order is), so each output
  is within 1 ulp of the reference's (equal in every case seen); lowrank:
  within 1e-5 relative of the largest value (the projection's matmuls sum
  in another order, and Omega's ``erfinv`` differs in the last ulps).
* ``serve.prng.normal`` against ``jax.random.normal``: the uniforms bit
  for bit, the normals within 1e-5 relative (``torch.erfinv`` against
  XLA's polynomial; 3e-6 seen).
* The tree baselines ``quantize_int8``, ``lowrank`` and
  ``compressed_bytes`` on the same trees (the bytes exactly).
* The compressed TP stack: the reference's own measurement
  (``repro.core.tp.make_tp_forward(mesh, 2, 64, 256, 8, "preln",
  grad_compress=m)``, gradients of ``sum(y ** 2)`` against the
  single-device ``_run_decoder_blocks``) beside the port's
  (``decoder_stack_tp`` on the same weights and input, two ranks):
  relative error of the parameter gradients and of the input gradient.
  The two packages compress at different sites (the reference the
  transpose of each forward psum, the port Megatron's *f*; ROADMAP.md
  Queue 3), so the port's int8 error is held to twice the reference's plus
  1e-3; the forward's collectives are ``"none"``'s, call for call; lowrank
  ships (m + d) r 4 bytes an exchange; int8's backward wire bytes are at
  most 0.3 of ``"none"``'s (``benchmarks/bench_comm.py``'s gate).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.optim import grad_compress as RG  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.optim import grad_compress as TG  # noqa: E402
from repro_torch.serve import prng  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from test_torch_train import _port_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("none", "int8", "lowrank")
MODE = "preln"
LOWRANK_TOL = 1e-5
TP = 2

#: the reference's side, in a process with two host devices: each exchange
#: under shard_map on per-rank slices of argv[1]'s inputs, and the
#: motivation measurement's gradients on one device and, under int8 (the
#: method whose error the port is held to), TP replicated and SP, written
#: to argv[2]
REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import tp as RTP
from repro.core.compat import shard_map
from repro.core.plan import ExecutionPlan
from repro.models import model as RM
from repro.optim import grad_compress as GC

inputs = dict(np.load(sys.argv[1]))
mode = sys.argv[3]
mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
out = {}
EXCHANGES = {"int8_allreduce": GC._int8_allreduce,
             "lowrank_allreduce": GC._lowrank_allreduce,
             "int8_allgather": GC._int8_allgather,
             "lowrank_allgather": GC._lowrank_allgather}
with jax.set_mesh(mesh):
    for pname, fn in EXCHANGES.items():
        for iname, x in inputs.items():
            if pname.endswith("allgather") != iname.startswith("gather"):
                continue
            f = shard_map(lambda v, fn=fn: fn(v[0], "model")[None],
                          mesh=mesh, in_specs=P("model"),
                          out_specs=P("model"), check_vma=False)
            out[f"x/{pname}/{iname}"] = np.asarray(jax.jit(f)(x))
    cfg = RTP.bench_stack_config(2, 64, 256, 8, mode)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 64))
    pos = jnp.broadcast_to(jnp.arange(16)[None], (2, 16))
    init, _ = RTP.make_tp_forward(mesh, 2, 64, 256, 8, mode)
    params = init(jax.random.PRNGKey(0))

    def one(p, x):
        y = RM._run_decoder_blocks(p, cfg, x, pos,
                                   ExecutionPlan.single_device())[0]
        return jnp.sum(y * y)
    g1 = jax.jit(jax.grad(one, argnums=(0, 1)))(params, x)
    for sp in (False, True):
        for m in ("int8",):
            _, fwd = RTP.make_tp_forward(mesh, 2, 64, 256, 8, mode, sp=sp,
                                         grad_compress=m)
            g = jax.jit(jax.grad(lambda p, x: jnp.sum(fwd(p, x) ** 2),
                                 argnums=(0, 1)))(params, x)
            for name, got, want in (("params", g[0], g1[0]),
                                    ("dx", g[1], g1[1])):
                a = np.concatenate([np.ravel(t) for t in
                                    jax.tree.leaves(got)])
                b = np.concatenate([np.ravel(t) for t in
                                    jax.tree.leaves(want)])
                out[f"err/{m}/{int(sp)}/{name}"] = np.array(
                    [np.linalg.norm(a - b) / np.linalg.norm(b),
                     np.linalg.norm(a) / np.linalg.norm(b)])
for path, leaf in jax.tree_util.tree_leaves_with_path(params):
    out["w/" + "/".join(k.key for k in path)] = np.asarray(leaf)
for i, t in enumerate(jax.tree.leaves(g1[0])):
    out[f"g1/{i}"] = np.asarray(t)
out["x"] = np.asarray(x)
out["g1x"] = np.asarray(g1[1])
np.savez(sys.argv[2], **out)
"""


def _inputs():
    """Per-rank inputs (2, ...): full-size chunks, an odd size (the int8
    padding; d = 5 still compressible at rank 4), a shape lowrank cannot
    compress (d = 3 <= 4) and tiled-gather shards along dim 1."""
    rng = np.random.default_rng(3)

    def draw(shape, scale):
        return (scale * rng.standard_normal((TP,) + shape)).astype(
            np.float32)
    return {"reduce_big": draw((2, 16, 64), 1.0),
            "reduce_odd": draw((3, 7, 5), 30.0),
            "reduce_thin": draw((4, 3), 0.01),
            "gather_big": draw((2, 8, 64), 1.0),
            "gather_odd": draw((1, 5, 6), 7.0)}


def _unflatten(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grad_compress")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE,
                        str(tmp / "inputs.npz"), str(tmp / "ref.npz"), MODE],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    blocks = _unflatten(ref, "w/")
    ranks = tp.run_ranks("torch_dp_ranks:gc_world", TP, backend="gloo",
                         threads=1, timeout=R.RANKS_TIMEOUT,
                         workdir=str(tmp / "ranks"),
                         args=(inputs, blocks, ref["x"], MODE, METHODS))
    return {"inputs": inputs, "ref": ref, "blocks": blocks, "ranks": ranks}


def _pairs(runs, pname):
    for iname in runs["inputs"]:
        if pname.endswith("allgather") != iname.startswith("gather"):
            continue
        want = runs["ref"][f"x/{pname}/{iname}"]
        for r, rank in enumerate(runs["ranks"]):
            yield iname, rank["primitives"][(pname, iname)].numpy(), want[r]


@pytest.mark.parametrize("pname", ["int8_allreduce", "int8_allgather"])
def test_int8_exchanges_match_reference(runs, pname):
    for iname, got, want in _pairs(runs, pname):
        assert got.shape == want.shape, iname
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("pname", ["lowrank_allreduce", "lowrank_allgather"])
def test_lowrank_exchanges_match_reference(runs, pname):
    for iname, got, want in _pairs(runs, pname):
        assert got.shape == want.shape, iname
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= LOWRANK_TOL, (iname, err)


def test_exchange_counts(runs):
    """A compressed all-reduce is one all-to-all and one all-gather of
    int8 (scales inside) or two rank-r all-reduces; an incompressible
    shape takes one exact all-reduce."""
    p = runs["ranks"][0]["primitives"]
    c = p[("int8_allreduce", "reduce_big", "counts")]
    n = 2 * 16 * 64
    assert tp.count(c, "all-to-all", "backward") == 1
    assert tp.count(c, "all-gather", "backward") == 1
    assert tp.count(c, "all-to-all", "backward", "bytes") == n + TP * 4
    assert tp.count(c, "all-gather", "backward", "bytes") == n + TP * 4
    c = p[("lowrank_allreduce", "reduce_big", "counts")]
    assert tp.count(c, "all-reduce", "backward") == 2
    assert tp.count(c, "all-reduce", "backward", "bytes") == \
        (32 + 64) * 4 * 4
    c = p[("lowrank_allreduce", "reduce_thin", "counts")]
    assert tp.count(c, "all-reduce", "backward", "bytes") == 4 * 3 * 4
    for iname in ("reduce_thin",):
        x = runs["inputs"][iname]
        np.testing.assert_allclose(
            p[("lowrank_allreduce", iname)].numpy(), x.sum(0), rtol=1e-6)


def test_prng_normal_matches_jax():
    for seed, shape in ((5, (64, 4)), (32 * 131 + 64, (64, 4)),
                        (12345, (1000,))):
        n = int(np.prod(shape))
        key = jax.random.PRNGKey(seed)
        lo = np.nextafter(np.float32(-1), np.float32(0))
        u_ref = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo,
                                              1.0)).reshape(-1)
        u = prng.uniform(prng.prng_key(seed), n, float(lo), 1.0).numpy()
        assert u.tobytes() == u_ref.tobytes()
        want = np.asarray(jax.random.normal(key, shape, jnp.float32))
        got = prng.normal(prng.prng_key(seed), n).reshape(shape).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((48, 20)).astype(np.float32),
            "b": {"v": (3 * rng.standard_normal(7)).astype(np.float32),
                  "m": rng.standard_normal((4, 9)).astype(np.float32)},
            "h": rng.standard_normal((6, 5)).astype(np.float16)}


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_quantize_int8_tree_matches_reference():
    tree = _tree(0)
    want = jax.tree.map(np.asarray, RG.quantize_int8(
        jax.tree.map(jnp.asarray, tree)))
    got = TG.quantize_int8(_torch(tree))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves_with_path(
                                    jax.tree.map(lambda t: t.numpy(), got))):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_max_ulp(b, a, maxulp=1)


def test_lowrank_tree_matches_reference():
    tree = {k: v for k, v in _tree(1).items() if k != "h"}
    for seed in (0, 7):
        want = RG.lowrank(jax.tree.map(jnp.asarray, tree), seed=seed)
        got = TG.lowrank(_torch(tree), seed=seed)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), got))):
            a = np.asarray(a)
            assert np.abs(a - b).max() <= LOWRANK_TOL * np.abs(a).max()


@pytest.mark.parametrize("method", METHODS)
def test_compressed_bytes_exact(method):
    tree = _tree(2)
    assert TG.compressed_bytes(_torch(tree), method) == \
        RG.compressed_bytes(jax.tree.map(jnp.asarray, tree), method)
    assert TG.GRAD_COMPRESS_METHODS == RG.GRAD_COMPRESS_METHODS
    assert TG._LOWRANK_RANK == RG._LOWRANK_RANK


def _stack(runs, method, sp):
    return [r["stack"][(method, sp)] for r in runs["ranks"]]


def _errors(runs, method, sp):
    """The port's (relative error, norm ratio) of the parameter and input
    gradients against the reference's one device on the same weights."""
    ref = runs["ref"]
    cfg = tp.bench_stack_config(2, 64, 256, 8, MODE)
    ranks = _stack(runs, method, sp)
    got = MX.gather_params([r["grads"] for r in ranks], cfg)
    n_leaves = len([k for k in ref if k.startswith("g1/")])
    leaves = [ref[f"g1/{i}"] for i in range(n_leaves)]
    want = _port_params(jax.tree.unflatten(
        jax.tree.structure(runs["blocks"]), leaves), cfg)
    from repro_torch.optim.adamw import named_leaves
    w = dict(named_leaves(want))
    a = torch.cat([t.reshape(-1) for p, t in named_leaves(got)])
    b = torch.cat([w[p].reshape(-1) for p, _ in named_leaves(got)])
    out = {"params": ((a - b).norm() / b.norm()).item()}
    dx, dx_ref = ranks[0]["dx"], torch.from_numpy(ref["g1x"])
    out["dx"] = ((dx - dx_ref).norm() / dx_ref.norm()).item()
    return out


@pytest.mark.parametrize("sp", [False, True])
def test_exact_path_matches_one_device(runs, sp):
    for name, err in _errors(runs, "none", sp).items():
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("sp", [False, True])
def test_int8_gradient_error_within_reference(runs, sp):
    """The port's int8 gradients against exact one-device gradients: at
    most twice the reference's relative error plus 1e-3."""
    got = _errors(runs, "int8", sp)
    for name, err in got.items():
        ref_err = float(runs["ref"][f"err/int8/{int(sp)}/{name}"][0])
        assert 0 < err <= 2 * ref_err + 1e-3, (name, err, ref_err)


@pytest.mark.parametrize("method", ["int8", "lowrank"])
@pytest.mark.parametrize("sp", [False, True])
def test_compressed_forward_counts_equal_none(runs, method, sp):
    for r_none, r_m in zip(_stack(runs, "none", sp),
                           _stack(runs, method, sp)):
        assert r_m["forward"] == r_none["forward"]


def _backward_exchanges(runs, sp):
    """The compressed sites of "none"'s backward: (the *f* all-reduces,
    the all-gathers behind the forward reduce-scatters, the exact
    all-gathers of ``split_seq``'s backward at the stack's entry)."""
    c = _stack(runs, "none", sp)[0]
    n_rs = tp.count(c["forward"], "reduce-scatter")
    n_ag = tp.count(c["backward"], "all-gather", "backward")
    return tp.count(c["backward"], "all-reduce", "backward"), n_rs, n_ag - n_rs


#: bytes of one exact (2, 16, 64) fp32 gathered cotangent
FULL_BYTES = 2 * 16 * 64 * 4


@pytest.mark.parametrize("sp", [False, True])
def test_lowrank_bytes_follow_the_factor_sizes(runs, sp):
    """Each compressed exchange of a (2, 16, 64) cotangent ships (m + d) r
    4 bytes (m = 32 rows, or 16 on an SP shard; d = 64; r = 4): two
    all-reduces of an *f*, two all-gathers of a shard's factors; the
    gathers at the stack's entry stay exact."""
    n_f, n_gather, n_exact = _backward_exchanges(runs, sp)
    c = _stack(runs, "lowrank", sp)[0]["backward"]
    r, d = TG._LOWRANK_RANK, 64
    assert tp.count(c, "all-reduce", "backward") == 2 * n_f
    assert tp.count(c, "all-reduce", "backward", "bytes") == \
        n_f * (32 + d) * r * 4
    assert tp.count(c, "all-gather", "backward") == 2 * n_gather + n_exact
    assert tp.count(c, "all-gather", "backward", "bytes") == \
        n_gather * TP * (16 + d) * r * 4 + n_exact * FULL_BYTES
    assert (n_f > 0) != sp and (n_gather > 0) == sp


@pytest.mark.parametrize("sp", [False, True])
def test_int8_wire_bytes_at_most_0_3_of_none(runs, sp):
    """``bench_comm``'s gate, on the backward collectives a method
    compresses: the all-reduces of the *f*'s, and under SP the all-gathers
    behind the reduce-scatters (the stack entry's gather and the
    reduce-scatters behind the LN regions' all-gathers stay exact in both
    packages)."""
    n_f, n_gather, n_exact = _backward_exchanges(runs, sp)
    exact_wire = n_exact * FULL_BYTES // TP

    def wire(method):
        c = _stack(runs, method, sp)[0]["backward"]
        if not sp:
            return sum(v["backward"]["wire"] for v in c.values())
        return tp.count(c, "all-gather", "backward", "wire") - exact_wire
    none, int8, low = (wire(m) for m in METHODS)
    assert none > 0
    assert int8 <= 0.3 * none, (int8, none)
    assert low < none, (low, none)
