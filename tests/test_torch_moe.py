"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``), on the CPU in fp32.

``moe_apply``'s output and aux equal the reference's within 1e-5, and its
gradients (every parameter and the input, of ``sum(y^2) + aux``) within
1e-5 of each leaf's largest value (the router's reach ~80), on the reduced
qwen3-moe: as it is (dropless), at ``capacity_factor = 1.0`` over enough
tokens that pairs drop, with group-limited routing (2 groups, limit 1),
with a shared expert, and on router weights with duplicated columns, where
the top-k and the group top-2 / top-L meet ties.  ``_topk`` returns
``jax.lax.top_k``'s order on ties.  The explicit-TP partial sums over each
rank's experts add up to ``moe_apply``.

Expert parallelism: four gloo ranks (``core.tp.run_ranks``) hold a quarter
of the tokens and of the experts each; ``moe_apply_sharded`` and
``moe_apply_shard_slot`` give the reference ``moe_apply``'s output and
gradients within its own tests' bounds (``tests/test_distributed.py:234``
and ``:330``: 1e-5 and 3e-5, gradients 1e-3) at their shapes: E 8, top 2,
``capacity_factor = 8`` so that each source shard's capacity C = 2 T
covers every pair (dropless, which the sharded paths need to equal the
one-device oracle: their capacity is per source shard); shard-slot with 4
groups, limit 2.  The all-to-all counts are those of the reference's
dispatch.
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMO  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.models import moe as TMO  # noqa: E402

import torch_tp_ranks as R  # noqa: E402

TOL = 1e-5
ARCH = "qwen3-moe-30b-a3b"

#: {case: (config kwargs, (B, S) of x, duplicated router columns)}
CASES = {
    "reduced": ({}, (2, 12), 0),
    # C = max(4, ceil(96 * 2 / 4 * 1.0)) = 48 < the busiest expert's load
    "drops": (dict(capacity_factor=1.0), (4, 24), 0),
    "groups": (dict(route_groups=2, route_group_limit=1), (2, 12), 0),
    "shared": (dict(n_shared_experts=1), (2, 12), 0),
    # expert 2j + 1's router column equals expert 2j's: every token's
    # probabilities tie in pairs, at the top-k cut and in the groups
    "ties": (dict(n_experts=8, top_k=3, route_groups=4,
                  route_group_limit=2), (2, 12), 2),
}


def _cfgs(**kw):
    return (ref_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


def _weights(cfg, seed, dup=0):
    """Reference-layout MoE weights from numpy at moe_init's scales; with
    ``dup`` > 1 the router's columns repeat in runs of ``dup``."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    router = normal((d, E), d)
    if dup > 1:
        router = np.repeat(router[:, ::dup], dup, axis=1)
    p = {"router": router, "wi": normal((E, d, f), d),
         "wg": normal((E, d, f), d), "wo": normal((E, f, d), f)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"wi": normal((d, fs), d), "wg": normal((d, fs), d),
                       "wo": normal((fs, d), fs)}
    return p


def _torch_tree(p):
    if isinstance(p, dict):
        return {k: _torch_tree(v) for k, v in p.items()}
    return torch.from_numpy(np.array(p)).requires_grad_(True)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _reference(rcfg, p, x):
    def loss(q, xx):
        y, aux = RMO.moe_apply(q, rcfg, xx)
        return jnp.sum(y ** 2) + aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, gp), \
        np.asarray(gx)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case):
    kw, (B, S), dup = CASES[case]
    rcfg, tcfg = _cfgs(**kw)
    p = _weights(rcfg, 0, dup)
    x = np.random.default_rng(1).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    y_r, aux_r, gp_r, gx_r = _reference(rcfg, p, x)
    tp_ = _torch_tree(p)
    xt = torch.from_numpy(x).requires_grad_(True)
    with TMO.counting_drops() as drops:
        y, aux = TMO.moe_apply(tp_, tcfg, xt)
    ((y ** 2).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), y_r, atol=TOL, rtol=0)
    assert abs(float(aux.detach()) - aux_r) <= TOL
    want = {("x",): gx_r, **_flat(gp_r)}
    got = {("x",): xt.grad, **{k: t.grad for k, t in _flat(tp_).items()}}
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max(),
                                   err_msg=str(path))
    assert drops["pairs"] == B * S * tcfg.top_k
    assert (int(drops["dropped"]) > 0) == (case == "drops")


@pytest.mark.parametrize("seed", range(4))
def test_topk_ties_follow_lax_top_k(seed):
    """Small integers tie everywhere: the indices (and so the experts and
    the groups) are ``jax.lax.top_k``'s, lowest index first."""
    x = np.random.default_rng(seed).integers(0, 4, (64, 16)).astype(
        np.float32)
    for k in (1, 2, 5, 16):
        v_r, i_r = jax.lax.top_k(jnp.asarray(x), k)
        v_t, i_t = TMO._topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_r))


def test_route_on_tied_logits_picks_the_references_experts():
    """Duplicated router columns: ``_route``'s experts and weights, with
    and without group limits, equal the reference's."""
    for kw in (dict(n_experts=8, top_k=3),
               dict(n_experts=8, top_k=3, route_groups=4,
                    route_group_limit=2)):
        rcfg, tcfg = _cfgs(**kw)
        p = _weights(rcfg, 2, dup=2)
        x = np.random.default_rng(3).standard_normal(
            (40, rcfg.d_model)).astype(np.float32)
        w_r, e_r, aux_r = RMO._route({"router": jnp.asarray(p["router"])},
                                     rcfg, jnp.asarray(x))
        w_t, e_t, aux_t = TMO._route(
            {"router": torch.from_numpy(p["router"])}, tcfg,
            torch.from_numpy(x))
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_r))
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_r), atol=TOL)
        assert abs(float(aux_t) - float(aux_r)) <= TOL


def test_partial_sums_over_ranks_equal_moe_apply():
    """``moe_apply_partial`` on each of two ranks' experts (a group
    stand-in with ``size`` / ``rank``) adds up to ``moe_apply``; the
    shared expert is split like a dense MLP; aux is the same on both."""
    rcfg, tcfg = _cfgs(n_shared_experts=1)
    p = _weights(rcfg, 4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 10, rcfg.d_model)).astype(np.float32))
    full = _torch_tree(p)
    with torch.no_grad():
        want, aux = TMO.moe_apply(full, tcfg, x)
        total = 0
        for r in range(2):
            group = types.SimpleNamespace(size=lambda: 2, rank=lambda r=r: r)
            sh = {"router": full["router"]}
            for k in ("wi", "wg", "wo"):
                sh[k] = full[k].chunk(2, 0)[r]
            sh["shared"] = {"wi": full["shared"]["wi"].chunk(2, 1)[r],
                            "wg": full["shared"]["wg"].chunk(2, 1)[r],
                            "wo": full["shared"]["wo"].chunk(2, 0)[r]}
            y, aux_r = TMO.moe_apply_partial(sh, tcfg, x, group)
            assert float(aux_r) == float(aux)
            total = total + y
    np.testing.assert_allclose(total.numpy(), want.numpy(), atol=TOL)


# --------------------------------------------------------------------------- #
# expert parallelism over four gloo ranks
# --------------------------------------------------------------------------- #
EP_KW = dict(n_experts=8, top_k=2, capacity_factor=8.0)
#: {case: (path, config kwargs, output bound)}: the reference's bounds
EP_CASES = {
    "sharded": ("sharded", EP_KW, 1e-5),
    "shard_slot": ("shard_slot",
                   dict(EP_KW, route_groups=4, route_group_limit=2), 3e-5),
    # a shared expert rides along: its leaves' gradients summed by *f*
    "shared": ("sharded", dict(EP_KW, n_shared_experts=1), 1e-5),
}
EP_GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def ep_case(tmp_path_factory):
    x = (np.random.default_rng(1).standard_normal((8, 32, 128)) * 0.5
         ).astype(np.float32)
    cases, refs = {}, {}
    for name, (path, kw, _) in EP_CASES.items():
        rcfg = ref_config(ARCH).reduced().replace(**kw)
        p = _weights(rcfg, 7)
        cases[name] = (path, kw, p)

        def loss(q, xx, rcfg=rcfg):
            return jnp.sum(RMO.moe_apply(q, rcfg, xx)[0] ** 2)
        y, _ = RMO.moe_apply(jax.tree.map(jnp.asarray, p), rcfg,
                             jnp.asarray(x))
        gp, gx = jax.grad(loss, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        refs[name] = (np.asarray(y), jax.tree.map(np.asarray, gp),
                      np.asarray(gx))
    rcfg = R.tp_config("fal", arch=ARCH)
    dp_case = (_model_weights(rcfg),
               np.random.default_rng(2).integers(0, 512, (4, 16)).astype(
                   np.int32))
    ranks = tp.run_ranks(
        "torch_moe_ranks:ep", 4, backend="gloo", threads=1,
        timeout=R.RANKS_TIMEOUT, args=(cases, x, dp_case),
        workdir=str(tmp_path_factory.mktemp("moe_ep")))
    return refs, ranks


def _model_weights(tcfg):
    """The reference-layout weights of ``tcfg`` (the port's config), from
    the reference's init."""
    rcfg = ref_config(ARCH).reduced().replace(
        connection=tcfg.connection, n_layers=tcfg.n_layers)
    return jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(5),
                                                   rcfg))


@pytest.mark.parametrize("name", list(EP_CASES))
def test_expert_parallel_matches_moe_apply(ep_case, name):
    refs, ranks = ep_case
    y_r, gp_r, gx_r = refs[name]
    bound = EP_CASES[name][2]
    got = [r[name] for r in ranks]
    y = torch.cat([g["y"] for g in got], 1).numpy()
    assert np.abs(y - y_r).max() < bound
    gx = torch.cat([g["grads"]["x"] for g in got], 1).numpy()
    assert np.abs(gx - gx_r).max() < EP_GRAD_TOL
    for k in ("wi", "wg", "wo"):        # each rank's experts, whole
        g = torch.cat([r["grads"][k] for r in got], 0).numpy()
        assert np.isfinite(g).all()
        assert np.abs(g - gp_r[k]).max() < EP_GRAD_TOL, k
    for r in got:                       # replicated leaves: whole on each
        assert np.abs(r["grads"]["router"].numpy()
                      - gp_r["router"]).max() < EP_GRAD_TOL
        for k, v in r["grads"].get("shared", {}).items():
            assert np.abs(v.numpy() - gp_r["shared"][k]).max() \
                < EP_GRAD_TOL, k
    # aux: the group's mean, the same on every rank
    assert len({r["aux"] for r in got}) == 1


@pytest.mark.parametrize("name,a2a_fwd,a2a_bwd", [
    ("sharded", 2, 2), ("shard_slot", 4, 3), ("shared", 2, 2)])
def test_expert_parallel_collective_counts(ep_case, name, a2a_fwd, a2a_bwd):
    """sharded: dispatch and return; shard-slot: tokens, expert ids,
    weights and partials (the ids carry no gradient).  One forward
    all-reduce (aux's mean) and one backward all-reduce per replicated
    leaf entered through *f* (the router, and the shared expert's three)."""
    _, ranks = ep_case
    n_rep = 4 if EP_CASES[name][1].get("n_shared_experts") else 1
    for r in ranks:
        c = r[name]
        assert tp.count(c["forward"], "all-to-all") == a2a_fwd
        assert tp.count(c["backward"], "all-to-all", "backward") == a2a_bwd
        assert tp.count(c["forward"], "all-reduce") == 1
        assert tp.count(c["backward"], "all-reduce", "backward") == n_rep


def test_data_group_mean_of_aux(ep_case):
    """tp 2 x dp 2 (the reference's pmean over the data axes,
    ``model.py:192-194``): with a data group in the plan, aux is the mean
    of the two data ranks' aux, the same on all four ranks, while the loss
    takes it and the router's gradient stays the rank's own (the train
    step averages gradients over the data group)."""
    _, ranks = ep_case
    got = [r["dp"] for r in ranks]
    # rank = dp_rank * 2 + tp_rank: ranks 0, 1 hold data rank 0's rows
    mean = (got[0]["aux_local"] + got[2]["aux_local"]) / 2
    assert got[0]["aux_local"] != got[2]["aux_local"]
    for g in got:
        assert abs(g["aux"] - mean) <= 1e-6
        assert g["router_grad_equal"]
        coef = R.tp_config("fal", arch=ARCH).router_aux_coef
        assert abs((g["loss"] - g["loss_local"])
                   - coef * (g["aux"] - g["aux_local"])) <= 1e-6
