"""The port's model slice against the JAX package: one token-packed
``paged_decode_step`` tick from the same weights (carried across with
``interop.params_from_numpy``), the same cache and the same packed batch.
fp32 on both sides; hidden states, the per-slot ``a1_sig`` and the written
K/V pools agree within 1e-4 (two layers of fp32 matmuls summed in another
order, activations of order 1)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = 1e-4
_init = jax.jit(RM.init_params, static_argnums=1)


def _configs(arch, connection):
    return (ref_config(arch).reduced().replace(connection=connection),
            get_config(arch).reduced().replace(connection=connection))


def _packed_batch(cfg, rng):
    """Slot 0 prefills 6 tokens, slot 1 continues a segment at 9..11, slot
    2 decodes one token at 20, slot 3 sits out; 3 padding rows."""
    S, Tb = 4, 8
    bt = np.zeros((S, Tb), np.int32)
    bt[0, :2] = [3, 7]
    bt[1, :3] = [1, 4, 9]
    bt[2, :6] = [2, 5, 6, 8, 10, 11]
    tok_slot = np.array([0] * 6 + [1] * 3 + [2] + [0] * 3, np.int32)
    tok_pos = np.array(list(range(6)) + [9, 10, 11, 20] + [-1] * 3, np.int32)
    seg_last = np.array([5, 8, 9, -1], np.int32)
    tokens = rng.integers(0, cfg.vocab, tok_slot.shape).astype(np.int32)
    return dict(tokens=tokens, tok_slot=tok_slot, tok_pos=tok_pos,
                block_tables=bt, seg_last=seg_last)


def _filled_caches(rcfg, tcfg, rng, num_pages=12, page=4, slots=4):
    """The same random history in both packages' caches."""
    rc = RM.init_paged_cache(rcfg, num_pages, page, slots, "float32")
    rc = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(
            np.float32)), rc)
    tc = TM.init_paged_cache(tcfg, num_pages, page, slots, "float32",
                             device="cpu")
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            tc[part][name].copy_(torch.from_numpy(np.array(rc[part][name])))
    tc["a1_sig"].copy_(torch.from_numpy(np.array(rc["a1_sig"])))
    return rc, tc


def _tick(arch, connection, want="hidden", plans=(None, None)):
    rcfg, tcfg = _configs(arch, connection)
    rng = np.random.default_rng(0)
    rparams = _init(jax.random.PRNGKey(1), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    rc, tc = _filled_caches(rcfg, tcfg, rng)
    batch = _packed_batch(rcfg, rng)
    r_out, r_cache = RM.paged_decode_step(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
        plans[0], want=want)
    t_out, t_cache = TM.paged_decode_step(
        tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        tc, plans[1], want=want)
    return batch, (np.asarray(r_out), r_cache), (t_out, t_cache)


def _close(a, b):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=0)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gpt2-117m"])
@pytest.mark.parametrize("connection", ["preln", "parallel", "fal",
                                        "falplus"])
def test_packed_tick_matches_reference(arch, connection):
    ops.reset_dispatch_paths()
    batch, (r_h, r_c), (t_h, t_c) = _tick(arch, connection)
    live = batch["tok_pos"] >= 0
    assert t_h.shape == r_h.shape
    _close(r_h[0, live], t_h[0, live])
    _close(r_c["a1_sig"], t_c["a1_sig"])
    for part in ("block0", "blocks"):
        for name in ("k", "v"):
            _close(r_c[part][name], t_c[part][name])
    assert ops.dispatch_paths() == {"paged_packed_attention": ops.PLAIN}


@pytest.mark.parametrize("arch,connection", [
    ("llama3.2-3b", "ablation1"), ("llama3.2-3b", "ablation2"),
    ("qwen3-4b", "fal"),                # qk_norm
    ("minicpm-2b", "fal"),              # multi-head (G = 1), rope 1e4
])
def test_packed_tick_logits_match_reference(arch, connection):
    batch, (r_l, r_c), (t_l, t_c) = _tick(arch, connection, want="logits")
    live = batch["tok_pos"] >= 0
    _close(r_l[0, live], t_l[0, live])
    _close(r_c["a1_sig"], t_c["a1_sig"])


def test_lm_head_matches_reference():
    rcfg, tcfg = _configs("llama3.2-3b", "fal")
    rparams = _init(jax.random.PRNGKey(2), rcfg)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        tcfg, "cpu")
    x = np.random.default_rng(3).standard_normal((3, 1, rcfg.d_model)) \
        .astype(np.float32)
    _close(RM.lm_head(rparams, rcfg, jnp.asarray(x)),
           TM.lm_head(tparams, tcfg, torch.from_numpy(x)))


def test_packed_scatter_matches_reference():
    rng = np.random.default_rng(4)
    pages = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    vals = rng.standard_normal((5, 2, 8)).astype(np.float32)
    bt = np.array([[1, 2, 0], [3, 4, 5]], np.int32)
    tok_slot = np.array([0, 0, 1, 1, 0], np.int32)
    tok_pos = np.array([3, 4, 0, 9, -1], np.int32)
    ref = RA.packed_scatter(jnp.asarray(pages), jnp.asarray(vals),
                            jnp.asarray(bt), jnp.asarray(tok_slot),
                            jnp.asarray(tok_pos), 4)
    out = torch.from_numpy(pages.copy())
    ret = TA.packed_scatter(out, torch.from_numpy(vals),
                            torch.from_numpy(bt), torch.from_numpy(tok_slot),
                            torch.from_numpy(tok_pos), 4)
    assert ret is out                           # updated in place
    live = np.ones(6, bool)
    live[0] = False                             # scratch page: any writer
    np.testing.assert_array_equal(out.numpy()[live], np.asarray(ref)[live])


def test_interop_carries_bf16_leaves_and_layouts():
    rcfg, tcfg = _configs("llama3.2-3b", "fal")
    rparams = _init(jax.random.PRNGKey(5), rcfg)
    bf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rparams)
    t = interop.params_from_numpy(jax.tree.map(np.asarray, bf16),
                                  tcfg.replace(dtype="bfloat16"), "cpu")
    assert len(t["blocks"]) == rcfg.n_layers - 1
    assert t["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert t["block0"]["ln_a"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        t["blocks"][0]["ffn"]["wo"].float().numpy(),
        np.asarray(bf16["blocks_dense"]["ffn"]["wo"][0].astype(jnp.float32)))


@pytest.mark.parametrize("arch,connection", [
    ("llama3.2-3b", "fal"), ("gpt2-117m", "preln"),
    ("llama3.2-3b", "falplus")])
def test_init_params_matches_reference_tree(arch, connection):
    rcfg, tcfg = _configs(arch, connection)
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
    ref = interop.params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        tcfg, "cpu")
    got = TM.init_params(tcfg, seed=0, device="cpu")

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {k2: v for k, v in tree.items()
                    for k2, v in flat(v, f"{pre}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v for i, v in enumerate(tree)
                    for k2, v in flat(v, f"{pre}/{i}").items()}
        return {pre: tree}

    fr, fg = flat(ref), flat(got)
    assert fr.keys() == fg.keys()
    for k in fr:
        assert fg[k].shape == fr[k].shape and fg[k].dtype == fr[k].dtype, k
    d = tcfg.d_model
    wq = got["block0"]["attn"]["wq"]
    assert abs(wq.std().item() * np.sqrt(d) - 1.0) < 0.1
    assert abs(got["embed"]["emb"].std().item() / 0.02 - 1.0) < 0.1


def test_entry_points_need_a_device_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means cuda")
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_paged_cache(cfg, 8, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.params_from_numpy({"embed": {"emb": np.zeros((4, 2))}}, cfg)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "gemma2-27b",
                                  "mamba2-370m", "llava-next-mistral-7b"])
def test_later_slice_families_raise(arch):
    with pytest.raises(NotImplementedError, match="slice"):
        TM.init_params(get_config(arch).reduced(), device="cpu")


def test_quantized_cache_raises():
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(NotImplementedError, match="quantized-KV"):
        TM.init_paged_cache(cfg, 8, 4, 2, kv_dtype="int8", device="cpu")


@pytest.mark.parametrize("connection", ["fal", "parallel", "ablation2"])
def test_dual_branch_packed_tick_matches_reference_and_sequential(
        connection):
    """A dual-branch plan on the packed tick: the same hidden states as
    the reference's dual packed tick, and bit for bit the port's own
    sequential packed tick (op for op the same path)."""
    from repro.core.plan import ExecutionPlan as RPlan
    from repro_torch.core.plan import ExecutionPlan as TPlan
    batch, (r_h, r_c), (t_h, t_c) = _tick(
        "llama3.2-3b", connection,
        plans=(RPlan.single_device("paged", dual_branch=True),
               TPlan.single_device("paged", dual_branch=True)))
    live = batch["tok_pos"] >= 0
    _close(r_h[0, live], t_h[0, live])
    _close(r_c["a1_sig"], t_c["a1_sig"])
    _, _, (s_h, s_c) = _tick("llama3.2-3b", connection)
    assert torch.equal(t_h, s_h)
    assert torch.equal(t_c["a1_sig"], s_c["a1_sig"])
