"""The port's radix prefix cache and copy-on-write pages against the JAX
package: the radix tree (the same insert / match / evict sequences through
both classes), the page copy (plain version against ``ref.copy_pages_ref``
and the Pallas ``page_copy`` in interpret mode, bit for bit, and the
wrapper's checks), ``copy_paged_pages`` across every layer, a plain mirror
of the cache-wide page-copy launch (its leaf table, its tasks and the
split at the cap of ``csrc/page_copy.cu``) against the reference, and the
prefix-cached engine: greedy streams equal to the reference's and to cold
runs, the seeded ``a1_sig`` of a full-prompt hit, COW among sharers,
dual-branch under preemption, re-prefill from the cached prefix after a
preemption, and ``stats()["prefix"]``; and (on a card only) the page-copy
kernel against its plain version, one pool and the whole cache."""
import functools
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.kernels import paged_attention as RPA  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.obs import metrics as RMET  # noqa: E402
from repro.serve import paged_cache as RPC  # noqa: E402
from repro.serve import prefix_cache as RPX  # noqa: E402
from repro.serve import scheduler as RS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import metrics as TMET  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serve import paged_cache as TPC  # noqa: E402
from repro_torch.serve import prefix_cache as TPX  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# --------------------------------------------------------------------------- #
# the radix tree: one script, both classes
# --------------------------------------------------------------------------- #
class _Run:
    """A scripted session against one package's allocator + prefix cache:
    each step appends what it observed to ``log``."""

    def __init__(self, pc_mod, pa_mod, met_mod, page=4, pages=64,
                 max_pages=0):
        self.a = pa_mod.PageAllocator(num_pages=pages, page_size=page)
        self.pc = pc_mod.PrefixCache(self.a, max_pages=max_pages,
                                     metrics=met_mod.MetricsRegistry())
        self.log = []

    def insert(self, toks, a1=None, pinned=False):
        """A finishing request: alloc, insert (the tree takes its own
        reference), release the request's."""
        toks = np.asarray(toks, np.int64)
        pages = self.a.alloc(len(toks) // self.a.page_size)
        self.log.append(("insert", self.pc.insert(toks, pages, a1=a1,
                                                  pinned=pinned)))
        self.a.free(pages)

    def match(self, toks, hold=False):
        n, pages, a1 = self.pc.match(np.asarray(toks, np.int64))
        self.log.append(("match", n, len(pages),
                         {q: np.asarray(s).tolist() for q, s in a1.items()}))
        if hold:
            self.a.share(pages)
        return pages

    def evict(self, n):
        self.log.append(("evict", self.pc.evict(n)))

    def state(self):
        st = self.pc.stats()
        self.log.append(("state", self.pc.n_pages, self.a.in_use, st))


def _script_match_divergence(r):
    r.insert(range(12))
    r.match(list(range(12)) + [99])
    r.match(list(range(9)) + [99, 99, 99])
    r.match([99] * 12)
    r.insert(list(range(8)) + [50, 51, 52, 53])
    r.match(list(range(8)) + [50, 51, 52, 53])
    r.match(range(12))
    r.state()


def _script_a1_roundtrip(r):
    r.insert(range(8), a1={7: np.arange(16, dtype=np.float32)})
    r.match(list(range(8)) + [9] * 4)
    r.match([0, 1, 2, 3, 9, 9, 9, 9])
    r.insert([0, 1, 2, 3, 20, 21, 22, 23])
    r.match(list(range(8)) + [9] * 4)
    r.state()


def _script_lru_referenced(r):
    r.insert(range(0, 8))
    r.insert(range(100, 108))
    r.match(range(100, 108))
    held = r.match(range(0, 8), hold=True)
    r.evict(100)
    r.match(range(0, 8))
    r.match(range(100, 108))
    r.a.free(held)
    r.evict(100)
    r.state()


def _script_cascade(r):
    r.insert(range(16))
    r.insert(list(range(8)) + [50, 51, 52, 53])
    r.state()
    r.evict(100)
    r.state()


def _script_budget(r):
    r.insert(range(8))
    r.insert(range(100, 112))
    r.state()


def _script_pinned(r):
    r.insert(range(8), pinned=True)
    r.insert(range(100, 108))
    r.evict(100)
    r.match(list(range(8)) + [9] * 4)
    r.state()


def _script_random_walk(seed):
    def script(r):
        rng = np.random.default_rng(seed)
        base = [list(rng.integers(0, 6, 16)) for _ in range(3)]
        for _ in range(40):
            op = rng.integers(0, 3)
            toks = base[rng.integers(0, 3)][:4 * int(rng.integers(1, 5))]
            toks = toks + list(rng.integers(0, 3, 4 * int(rng.integers(0,
                                                                      2))))
            if op == 0 and r.a.free_pages >= len(toks) // 4:
                r.insert(toks, a1={len(toks) - 1: [float(len(toks))]})
            elif op == 1:
                r.match(toks + [7])
            else:
                r.evict(int(rng.integers(1, 4)))
        r.state()
    return script


_SCRIPTS = {"match_divergence": (_script_match_divergence, {}),
            "a1_roundtrip": (_script_a1_roundtrip, {}),
            "lru_referenced": (_script_lru_referenced, {}),
            "cascade": (_script_cascade, {}),
            "budget": (_script_budget, dict(max_pages=3)),
            "pinned": (_script_pinned, {}),
            "random_walk_0": (_script_random_walk(0), dict(pages=24)),
            "random_walk_1": (_script_random_walk(1), dict(pages=12))}


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_radix_tree_matches_reference(name):
    """The same insert / match / evict script through the reference's and
    the port's allocator and prefix cache: the same hits, page counts, a1
    artifacts, evictions and stats at every step, and the pool drained by
    ``clear`` at the end."""
    script, kw = _SCRIPTS[name]
    logs = []
    for mods in ((RPX, RPC, RMET), (TPX, TPC, TMET)):
        r = _Run(*mods, **kw)
        script(r)
        r.pc.clear()
        assert r.a.in_use == 0
        logs.append(r.log)
    assert logs[1] == logs[0]


# --------------------------------------------------------------------------- #
# the page copy
# --------------------------------------------------------------------------- #
def _pool(kind, rng, P=10, page=4):
    if kind == "bf16":
        return np.asarray(jnp.asarray(rng.standard_normal(
            (P, page, 2, 8))).astype(jnp.bfloat16))
    if kind == "int8":
        return rng.integers(-128, 128, (P, page, 2, 8)).astype(np.int8)
    if kind == "fp8":
        return np.asarray(jnp.asarray(rng.standard_normal(
            (P, page, 2, 8)) * 50).astype(jnp.float8_e4m3fn))
    return rng.uniform(1e-4, 2.0, (P, page)).astype(np.float32)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8", "fp32-scales"])
def test_copy_pages_matches_reference_bit_exact(kind):
    """``ops.copy_pages`` on the CPU (the plain version, in place) against
    ``ref.copy_pages_ref`` and the Pallas ``page_copy`` in interpret mode:
    the same bytes, with a repeated src page; pages outside dst keep
    theirs."""
    rng = np.random.default_rng(0)
    pool = _pool(kind, rng)
    src, dst = [1, 3, 1], [4, 2, 5]
    want = np.asarray(RREF.copy_pages_ref(jnp.asarray(pool), jnp.asarray(src),
                                          jnp.asarray(dst)))
    pallas = np.asarray(RPA.page_copy(jnp.asarray(pool),
                                      jnp.asarray(src, jnp.int32),
                                      jnp.asarray(dst, jnp.int32),
                                      interpret=True))
    t = interop.cache_from_numpy({"p": pool}, "cpu")["p"]
    ops.reset_dispatch_paths()
    out = ops.copy_pages(t, src, dst)
    assert out is t                                # in place
    assert ops.dispatch_paths() == {"copy_pages": ops.PLAIN}
    np.testing.assert_array_equal(_bytes(t), _bytes(want))
    np.testing.assert_array_equal(_bytes(t), _bytes(pallas))
    np.testing.assert_array_equal(_bytes(t[[0, 6, 7]]),
                                  _bytes(pool[[0, 6, 7]]))


@pytest.mark.parametrize("src,dst,msg", [
    ([1, 2], [4, 4], "distinct"),
    ([1, 2], [2, 5], "also a src"),
    ([1], [4, 5], "src pages but"),
    ([1], [10], "outside")])
def test_copy_pages_rejects_overlap_and_repeated_dst(src, dst, msg):
    pool = torch.zeros(10, 4, 2)
    with pytest.raises(ValueError, match=msg):
        ops.copy_pages(pool, src, dst)
    with pytest.raises(ValueError, match=msg):
        PA.page_copy(pool, src, dst)


@pytest.mark.parametrize("kv", ["", "int8", "fp8"])
def test_copy_paged_pages_matches_reference_all_layers(kv):
    """``copy_paged_pages`` over every pool leaf (scales included, stacked
    layers through the flat view) gives the reference's cache, byte for
    byte, and leaves ``a1_sig`` alone: one copy_pages call per leaf."""
    cfg = ref_config("llama3.2-3b").reduced().replace(n_layers=3)
    rng = np.random.default_rng(1)
    cache = jax.tree.map(np.asarray, RM.init_paged_cache(
        cfg, 8, 4, 2, "float32", kv_dtype=kv))

    def fill(a):
        if a.dtype == np.int8:
            return rng.integers(-128, 128, a.shape).astype(np.int8)
        return np.asarray(jnp.asarray(rng.standard_normal(a.shape))
                          .astype(a.dtype))

    cache = jax.tree.map(fill, cache)
    want = RM.copy_paged_pages(jax.tree.map(jnp.asarray, cache),
                               jnp.asarray([2, 3], jnp.int32),
                               jnp.asarray([5, 6], jnp.int32))
    got = interop.cache_from_numpy(cache, "cpu")
    ops.reset_launches()
    TM.copy_paged_pages(got, [2, 3], [5, 6])
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, leaf in flat_w:
        t = got
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(_bytes(t), _bytes(leaf))
    assert ops.launch_counts()["page_copy"] == 0     # the CPU: plain only


def _copy_constants():
    """The page-copy kernel's constants from its source."""
    src = pathlib.Path(PA.__file__).parent / "csrc" / "page_copy.cu"
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                            src.read_text()))
    return {k: int(const[k]) for k in ("kThreads", "kInFlight",
                                       "kMaxLeaves", "kMaxPairs")}


def _mirror_cow_plan(cache, src, dst):
    """A plain mirror of the cache-wide page copy: the leaf table (block
    0's pools, then the stacked pools: base, bytes a page, pages a layer,
    layers; at most kMaxLeaves), its launches (the pairs in runs of
    kMaxPairs) and, for each, its blocks in order: (leaf, layer, src page,
    dst page, first byte, bytes) with the page's chunks of kThreads x
    kInFlight units (16 bytes where the page size and the base allow, else
    one), layer-major, then pair, then chunk.  Returns (leaves, table,
    [(table, src, dst, tasks)])."""
    c = _copy_constants()
    leaves = [(p, False) for p in cache["block0"].values()] \
        + [(p, True) for p in cache["blocks"].values()]
    table = []
    for pool, stacked in leaves:
        L, P = pool.shape[:2] if stacked else (1, pool.shape[0])
        table.append((pool.data_ptr(), pool.numel() // (L * P)
                      * pool.element_size(), P, L))
    assert len(table) <= c["kMaxLeaves"]
    plans = []
    for j in range(0, len(src), c["kMaxPairs"]):
        s, d = src[j:j + c["kMaxPairs"]], dst[j:j + c["kMaxPairs"]]
        tasks = []
        for k, (base, nbytes, _, L) in enumerate(table):
            unit = 16 if nbytes % 16 == 0 and base % 16 == 0 else 1
            chunk = c["kThreads"] * c["kInFlight"] * unit
            tasks += [(k, layer, s[n], d[n], off, min(chunk, nbytes - off))
                      for layer in range(L) for n in range(len(s))
                      for off in range(0, nbytes, chunk)]
        plans.append((table, s, d, tasks))
    return leaves, table, plans


_COW_CASES = {"n=1": ([2], [5]), "n=3, repeated src": ([2, 7, 2], [5, 6, 9]),
              "n above the cap": (list(range(1, 262)), list(range(300, 561)))}


@pytest.mark.parametrize("case", list(_COW_CASES))
@pytest.mark.parametrize("kv", ["", "int8", "fp8"])
def test_cow_launch_plan_matches_reference(kv, case):
    """The mirror's tasks, run one after the other on byte views of the
    port's cache (blocks run in no order; dst pages are disjoint from src,
    so any order gives these bytes), give ``RM.copy_paged_pages``'s cache
    byte for byte on bf16, int8 and fp8 caches with their scales; the
    module's leaf table and launch split are the mirror's, one launch a
    COW up to the cap and one more past it."""
    src, dst = _COW_CASES[case]
    cfg = ref_config("llama3.2-3b").reduced().replace(n_layers=3)
    rng = np.random.default_rng(len(kv) + len(src))
    cache = jax.tree.map(np.asarray, RM.init_paged_cache(
        cfg, 600, 4, 2, "bfloat16", kv_dtype=kv))

    def fill(a):
        if a.dtype == np.int8:
            return rng.integers(-128, 128, a.shape).astype(np.int8)
        return np.asarray(jnp.asarray(rng.standard_normal(a.shape))
                          .astype(a.dtype))

    cache = jax.tree.map(fill, cache)
    want = RM.copy_paged_pages(jax.tree.map(jnp.asarray, cache),
                               jnp.asarray(src, jnp.int32),
                               jnp.asarray(dst, jnp.int32))
    got = interop.cache_from_numpy(cache, "cpu")
    leaves, table, plans = _mirror_cow_plan(got, src, dst)
    assert table == PA.copy_leaf_table(leaves)
    assert [p[:3] for p in plans] == PA.copy_launches(table, src, dst)
    cap = _copy_constants()["kMaxPairs"]
    assert len(plans) == -(-len(src) // cap)
    rows = [pool.reshape(t[2] * t[3], -1).view(torch.uint8)
            for (pool, _), t in zip(leaves, table)]
    for tab, _, _, tasks in plans:
        assert len(tasks) < 2 ** 31
        for leaf, layer, s, d, off, n in tasks:
            P = table[leaf][2]
            rows[leaf][layer * P + d, off:off + n] = \
                rows[leaf][layer * P + s, off:off + n]
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        t = got
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(_bytes(t), _bytes(leaf))


def test_page_copy_cap_matches_source():
    """The wrapper's caps are the kernel's, the parameter block they size
    stays under 4 KB (16 leaves of 48 bytes, two counts, the pairs), and a
    copy past the pair cap is split into runs of the cap, every launch
    with the whole leaf table."""
    c = _copy_constants()
    assert (PA.COPY_MAX_PAIRS, PA.COPY_MAX_LEAVES) == (c["kMaxPairs"],
                                                      c["kMaxLeaves"])
    assert c["kMaxLeaves"] * 48 + 8 + 2 * 4 * c["kMaxPairs"] < 4096
    table = [(16 * i, 64, 1000, 1) for i in range(8)]
    src, dst = list(range(600)), list(range(600, 1200))
    got = PA.copy_launches(table, src, dst)
    assert [(t, s[0], len(s)) for t, s, _ in got] == [
        (table, 0, 256), (table, 256, 256), (table, 512, 88)]
    assert all(d == [x + 600 for x in s] for _, s, d in got)


def test_copy_page_leaves_checks_once():
    """``ops.copy_page_leaves`` checks the pairs once for all leaves (and
    raises on overlaps as ``copy_pages`` does), refuses leaves whose pages
    a layer differ, and records the ``copy_pages`` call site."""
    a, b = torch.zeros(10, 4, 2), torch.zeros(3, 10, 4)
    with pytest.raises(ValueError, match="also a src"):
        ops.copy_page_leaves([(a, False), (b, True)], [1, 2], [2, 5])
    with pytest.raises(ValueError, match="pages a layer"):
        ops.copy_page_leaves([(a, False), (torch.zeros(3, 9, 4), True)],
                             [1], [2])
    a[1], b[:, 1] = 1.0, 2.0
    ops.reset_dispatch_paths()
    ops.copy_page_leaves([(a, False), (b, True)], [1], [4])
    assert ops.dispatch_paths() == {"copy_pages": ops.PLAIN}
    assert torch.equal(a[4], a[1]) and torch.equal(b[:, 4], b[:, 1])


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _models(connection="fal"):
    rcfg = ref_config("llama3.2-3b").reduced().replace(connection=connection)
    tcfg = get_config("llama3.2-3b").reduced().replace(connection=connection)
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _kw(**kw):
    base = dict(page_size=8, num_pages=48, slots=2, prefill_chunk=8,
                max_seq=64, cache_dtype="float32", prefix_cache=True)
    base.update(kw)
    return base


def _engines(connection="fal", tracer=None, **kw):
    rcfg, rparams, tcfg, tparams = _models(connection)
    return (RS.PagedEngine(rcfg, rparams, RS.EngineConfig(**_kw(**kw))),
            TS.PagedEngine(tcfg, tparams, TS.EngineConfig(**_kw(**kw)),
                           tracer=tracer, device="cpu"))


def _sys_prompt(n=16, seed=3):
    return np.random.default_rng(seed).integers(1, 512, n)


def _drained(eng):
    eng.pcache.clear()
    assert eng.allocator.in_use == 0


def _prefix_stats(st):
    """``stats()["prefix"]`` without wall-clock series."""
    return {k: v for k, v in st["prefix"].items() if not k.endswith("_ms")}


@pytest.mark.parametrize("connection", ["fal", "preln", "parallel"])
def test_prefix_hit_streams_match_reference_and_cold(connection):
    """A donor parks its prefix; a probe that extends it hits (prefills
    only its divergence suffix) and a probe that repeats it verbatim enters
    decode on its first tick.  Streams, captured ``prefix_sig`` and
    ``stats()["prefix"]`` equal the reference's; the probes' streams equal
    a cold engine's."""
    sysp = _sys_prompt()
    tail = np.random.default_rng(5).integers(1, 512, 5)
    tracer = Tracer(enabled=True)
    engines = _engines(connection, tracer=tracer)
    runs = []
    for mod, eng in zip((RS, TS), engines):
        eng.submit(mod.ServeRequest(rid=1, prompt=sysp, max_new=4))
        eng.run()
        eng.reset_stats()
        probes = [mod.ServeRequest(rid=2, prompt=np.concatenate([sysp, tail]),
                                   max_new=4),
                  mod.ServeRequest(rid=3, prompt=sysp.copy(), max_new=5)]
        for p in probes:
            eng.submit(p)
        eng.run()
        runs.append((probes, eng.stats()))
    (rp, rst), (tp, tst) = runs
    assert [p.generated for p in tp] == [p.generated for p in rp]
    assert [p.prefix_hit_tokens for p in tp] == [16, 16]
    for r, t in zip(rp, tp):
        np.testing.assert_allclose(t.prefix_sig.numpy(),
                                   np.asarray(r.prefix_sig), atol=1e-5)
    assert _prefix_stats(tst) == _prefix_stats(rst)
    assert tst["prefill_tokens"] == rst["prefill_tokens"] == 5
    assert tst["prefix"]["hit_rate"] == 1.0
    names = {e["name"] for e in tracer.events}
    assert {"PREFIX_HIT", "COW", "engine.cow", "PREFIX_PARKED"} <= names
    cold = _engines(connection, prefix_cache=False)[1]
    cold.submit(TS.ServeRequest(rid=2, prompt=np.concatenate([sysp, tail]),
                                max_new=4))
    cold.submit(TS.ServeRequest(rid=3, prompt=sysp.copy(), max_new=5))
    assert {r.rid: r.generated for r in cold.run()} == \
        {p.rid: p.generated for p in tp}
    _drained(engines[1])


def test_full_prompt_hit_seeds_a1_sig_like_reference():
    """A full-prompt hit enters decode on its first tick with ``a1_sig``
    seeded at admission from the cached entry: the seeded row equals the
    reference's, no prefill runs, and the stream equals a cold run's."""
    sysp = _sys_prompt()
    ref, port = _engines()
    rows = []
    for mod, eng in ((RS, ref), (TS, port)):
        eng.submit(mod.ServeRequest(rid=1, prompt=sysp, max_new=4))
        eng.run()
        eng.reset_stats()
        probe = mod.ServeRequest(rid=2, prompt=sysp.copy(), max_new=5)
        eng.submit(probe)
        eng._admit()
        slot = eng.slots.index(probe)
        rows.append(np.asarray(eng.cache["a1_sig"][slot], np.float32))
        eng.run()
        st = eng.stats()
        assert st["prefill_tokens"] == 0 and st["ttft_ticks"]["p50"] == 1
        assert st["prefix"]["a1_sig_seeded"] == 1
        assert st["prefix"]["cow_copies"] == 1
        rows.append(probe.generated)
    np.testing.assert_allclose(rows[2], rows[0], atol=1e-5)
    assert np.abs(rows[2]).max() > 0
    assert rows[3] == rows[1]
    cold = _engines(prefix_cache=False)[1]
    cold.submit(TS.ServeRequest(rid=2, prompt=sysp.copy(), max_new=5))
    assert cold.run()[0].generated == rows[3]
    _drained(port)


def test_cow_leaves_other_sharers_bit_identical():
    """Three live requests share the donor's cached pages; the third
    repeats the prompt and must copy the shared last page before writing.
    Every sharer's stream equals its lone cold run and the reference's, and
    the shared pages' bytes are unchanged by the writes."""
    sysp = _sys_prompt()
    rng = np.random.default_rng(11)
    prompts = [np.concatenate([sysp, rng.integers(1, 512, 3 + k)])
               for k in range(2)] + [sysp.copy()]
    ref, port = _engines(slots=3)
    streams = []
    for mod, eng in ((RS, ref), (TS, port)):
        eng.submit(mod.ServeRequest(rid=0, prompt=sysp, max_new=4))
        eng.run()
        shared = [int(p) for p in eng.pcache.match(sysp)[1]]
        before = [_bytes(eng.cache["blocks"]["k"][:, shared]).copy()] \
            if mod is TS else None
        for k, p in enumerate(prompts):
            eng.submit(mod.ServeRequest(rid=10 + k, prompt=p, max_new=6))
        done = eng.run()
        streams.append({r.rid: r.generated for r in done if r.rid >= 10})
        assert eng.stats()["prefix"]["cow_copies"] == 1
        if mod is TS:
            np.testing.assert_array_equal(
                _bytes(eng.cache["blocks"]["k"][:, shared]), before[0])
    assert streams[1] == streams[0]
    for k, p in enumerate(prompts):
        lone = _engines(slots=1, prefix_cache=False)[1]
        lone.submit(TS.ServeRequest(rid=10 + k, prompt=p, max_new=6))
        assert lone.run()[0].generated == streams[1][10 + k]
    _drained(port)


def test_dual_branch_with_preemption_matches_reference_and_ample():
    """A page-starved dual-branch engine with the prefix cache (pressure
    relief evicts cached prefixes, then preempts) emits the reference's
    streams and those of an ample engine without the cache."""
    sysp = _sys_prompt()

    def reqs(mod):
        rng = np.random.default_rng(13)
        return [mod.ServeRequest(
            rid=k, prompt=np.concatenate([sysp, rng.integers(1, 512, 2)]),
            max_new=10 + (k % 3)) for k in range(6)]

    ref, port = _engines(slots=2, num_pages=7, dual_branch=True)
    outs = []
    for mod, eng in ((RS, ref), (TS, port)):
        for r in reqs(mod):
            eng.submit(r)
        done = eng.run()
        assert len(done) == 6 and not any(r.truncated for r in done)
        st = eng.stats()
        assert st["preemptions"] > 0 and st["prefix"]["hits"] > 0
        outs.append(({r.rid: r.generated for r in done}, st))
    (r_out, rst), (t_out, tst) = outs
    assert t_out == r_out
    assert tst["preemptions"] == rst["preemptions"]
    assert _prefix_stats(tst) == _prefix_stats(rst)
    ample = _engines(slots=2, num_pages=64, dual_branch=True,
                     prefix_cache=False)[1]
    for r in reqs(TS):
        ample.submit(r)
    assert {r.rid: r.generated for r in ample.run()} == t_out
    _drained(port)


def test_preempted_request_reprefills_from_cached_prefix():
    """A forced preemption frees none of the tree's pages, and the
    re-admission matches the cached prefix again, as in the reference."""
    sysp = _sys_prompt()
    probe_prompt = np.concatenate(
        [sysp, np.random.default_rng(4).integers(1, 512, 3)])
    out = []
    for mod, eng in zip((RS, TS), _engines()):
        eng.submit(mod.ServeRequest(rid=1, prompt=sysp, max_new=4))
        eng.run()
        assert eng.pcache.n_pages == 2
        probe = mod.ServeRequest(rid=2, prompt=probe_prompt, max_new=4)
        eng.submit(probe)
        eng._admit()
        eng._preempt(eng.slots.index(probe))
        assert eng.pcache.n_pages == 2
        eng.run()
        assert probe.prefix_hit_tokens == len(sysp)
        out.append((probe.generated, probe.preemptions,
                    _prefix_stats(eng.stats())))
        if mod is TS:
            _drained(eng)
    assert out[1] == out[0]


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_page_copy_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    rng = np.random.default_rng(2)
    for kind in ("bf16", "int8", "fp8", "fp32-scales"):
        pool = interop.cache_from_numpy({"p": _pool(kind, rng, P=40)},
                                        "cuda")["p"]
        for src, dst in (([1], [2]), ([3, 3, 5], [9, 10, 11]),
                         (list(range(1, 11)), list(range(20, 30)))):
            a, b = pool.clone(), pool.clone()
            PA.page_copy(a, src, dst)
            PA.copy_pages_plain(b, src, dst)
            torch.cuda.synchronize()
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    # the cache-wide launch: every leaf and layer of bf16 and int8 caches
    cfg = get_config("llama3.2-3b").reduced().replace(n_layers=3)
    for kv in ("", "int8"):
        cache = TM.init_paged_cache(cfg, 600, 4, 2, "bfloat16", kv_dtype=kv,
                                    device="cuda")
        for part in ("block0", "blocks"):
            for pool in cache[part].values():
                pool.view(torch.uint8).copy_(torch.randint(
                    0, 256, pool.view(torch.uint8).shape, dtype=torch.uint8))
        for src, dst in _COW_CASES.values():
            leaves, _, plans = _mirror_cow_plan(cache, src, dst)
            want = [PA.copy_pages_plain(pool.clone(), src, dst,
                                        stacked=stacked)
                    for pool, stacked in leaves]
            ops.reset_launches()
            TM.copy_paged_pages(cache, src, dst)
            torch.cuda.synchronize()
            assert ops.launch_counts()["page_copy"] == len(plans)
            assert all(torch.equal(w.view(torch.uint8),
                                   pool.view(torch.uint8))
                       for w, (pool, _) in zip(want, leaves))
