"""The port's MLA (DeepSeek-V3 multi-head latent attention) against the JAX
package's, function by function, on the CPU in fp32 at the reduced
deepseek-v3-671b (d 128, 4 heads, q_lora 48, kv_lora 32, qk heads of
32 + 16, v heads of 32), weights drawn by the reference's ``mla_init``:

* ``mla_apply`` (full sequence; the port through ``ops.flash_attention``
  at qk width 48 and v width 32) and its gradients;
* ``mla_decode`` over ragged positions, ``mla_paged_apply`` (C = 1 and a
  ragged chunk) and ``mla_packed_apply`` (a prefill, a continued segment, a
  decode and padding rows; more tokens than ``MLA_PACKED_CHUNK``), outputs
  and the written latent caches;
* the flash wrapper's ``Dv < D`` route on the CPU against the reference's
  ``blockwise_attention`` and its ``jax.vjp``;
* the bf16 kernels' rounding points at D = 192 (32-row tiles), emulated
  as ``test_torch_flash_attention.py`` does, within chip_smoke's bounds;
* MLA with a quantized ``kv_dtype`` raises, as in the reference.

Tolerance: 1e-5 x max(1, |ref|) (fp32 sums in another order)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

import test_torch_flash_attention as TFA  # noqa: E402

ARCH = "deepseek-v3-671b"


def _cfgs(**kw):
    return (ref_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


def _close(want, got):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _attn(rcfg, seed=0):
    """Reference MLA weights (``mla_init``) and their port copy."""
    rp = RA.mla_init(jax.random.PRNGKey(seed), rcfg)
    return rp, _torch_tree(jax.tree.map(np.asarray, rp))


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def test_mla_init_matches_the_reference_tree():
    rcfg, tcfg = _cfgs()
    rp, _ = _attn(rcfg)
    tp = TA.mla_init(torch.Generator().manual_seed(0), tcfg, torch.float32,
                     "cpu")
    assert list(tp) == list(rp)
    for k in rp:
        want = jax.tree.map(np.shape, rp[k])
        got = {kk: tuple(v.shape) for kk, v in tp[k].items()} \
            if isinstance(tp[k], dict) else tuple(tp[k].shape)
        assert got == want, k
    H, dv, L = tcfg.n_heads, tcfg.v_head_dim, tcfg.n_layers
    assert abs(tp["wo"].std().item() * np.sqrt(H * dv * 2 * L) - 1) < 0.1


def test_mla_apply_and_gradients_match_reference():
    rcfg, tcfg = _cfgs()
    rp, tp = _attn(rcfg)
    B, S = 2, 37
    x = _x(rcfg, (B, S))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    dout = np.random.default_rng(5).standard_normal((B, S, rcfg.d_model)) \
        .astype(np.float32)
    r_out, vjp = jax.vjp(lambda p, a: RA.mla_apply(p, rcfg, a,
                                                   jnp.asarray(pos)),
                         rp, jnp.asarray(x))
    r_gp, r_gx = vjp(jnp.asarray(dout))
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ops.reset_dispatch_paths()
    out = TA.mla_apply(tp, tcfg, tx, torch.from_numpy(pos))
    assert ops.dispatch_paths() == {"flash_attention": ops.PLAIN}
    _close(r_out, out)
    out.backward(torch.from_numpy(dout))
    _close(r_gx, tx.grad)
    for k, g in r_gp.items():
        if isinstance(g, dict):
            _close(g["scale"], tp[k]["scale"].grad)
        else:
            _close(g, tp[k].grad)


def test_mla_decode_matches_reference_over_ragged_positions():
    """Lane 0 advances every step, lane 1 every second (re-decoding its
    position in between); the output of each step and the written latent
    cache at the end equal the reference's."""
    rcfg, tcfg = _cfgs()
    rp, tp = _attn(rcfg)
    B, S = 2, 10
    rc = RA.mla_init_cache(rcfg, B, S, "float32")
    tc = TA.mla_init_cache(tcfg, B, S, torch.float32, "cpu")
    xs = _x(rcfg, (S, B, 1), seed=3)
    for t in range(S):
        pos = np.array([t, t // 2], np.int32)
        r_out, rc = RA.mla_decode(rp, rcfg, jnp.asarray(xs[t]), rc,
                                  jnp.asarray(pos))
        t_out, tc = TA.mla_decode(tp, tcfg, torch.from_numpy(xs[t]), tc,
                                  torch.from_numpy(pos))
        _close(r_out, t_out)
    for name in ("c", "kr"):
        _close(rc[name], tc[name])


def _pools(rcfg, tcfg, rng, P=14, page=4):
    rc = RA.mla_init_paged_cache(rcfg, P, page, "float32")
    rc = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in rc.items()}
    tc = TA.mla_init_paged_cache(tcfg, P, page, torch.float32, "cpu")
    for k in tc:
        tc[k].copy_(torch.from_numpy(np.array(rc[k])))
    return rc, tc


@pytest.mark.parametrize("C,lanes", [
    (1, ((3, 1), (9, 1), (2, 0), (14, 1))),
    (6, ((0, 6), (5, 3), (11, 0), (2, 1)))])
def test_mla_paged_apply_matches_reference(C, lanes):
    rcfg, tcfg = _cfgs()
    rp, tp = _attn(rcfg)
    rng = np.random.default_rng(C)
    rc, tc = _pools(rcfg, tcfg, rng)
    B, Tb = len(lanes), 3
    x = _x(rcfg, (B, C), seed=C)
    bt = rng.permutation(np.arange(1, 14))[:B * Tb].reshape(B, Tb) \
        .astype(np.int32)
    pos = np.array([p for p, _ in lanes], np.int32)
    nv = np.array([n for _, n in lanes], np.int32)
    r_out, r_c = RA.mla_paged_apply(rp, rcfg, jnp.asarray(x), rc,
                                    jnp.asarray(bt), jnp.asarray(pos),
                                    jnp.asarray(nv))
    t_out, t_c = TA.mla_paged_apply(tp, tcfg, torch.from_numpy(x), tc,
                                    torch.from_numpy(bt),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(nv))
    live = np.arange(C)[None] < nv[:, None]
    _close(np.asarray(r_out)[live], t_out.detach().numpy()[live])
    for k in ("c", "kr"):                   # page 0 is scratch
        _close(np.asarray(r_c[k])[1:], t_c[k][1:])


def test_mla_packed_apply_matches_reference(monkeypatch):
    """The packed batch of ``test_torch_model.py`` (a prefill of 6, a
    continued segment, a decode at 20, 3 padding rows), with the port's
    token chunk at 4 so that the 13 tokens take four chunks."""
    import test_torch_model as TMOD
    monkeypatch.setattr(TA, "MLA_PACKED_CHUNK", 4)
    rcfg, tcfg = _cfgs()
    rp, tp = _attn(rcfg)
    rng = np.random.default_rng(7)
    rc, tc = _pools(rcfg, tcfg, rng, P=12)
    b = TMOD._packed_batch(rcfg, rng)
    T = len(b["tok_slot"])
    x = _x(rcfg, (1, T), seed=8)
    r_out, r_c = RA.mla_packed_apply(
        rp, rcfg, jnp.asarray(x), rc, jnp.asarray(b["block_tables"]),
        jnp.asarray(b["tok_slot"]), jnp.asarray(b["tok_pos"]))
    t_out, t_c = TA.mla_packed_apply(
        tp, tcfg, torch.from_numpy(x), tc,
        torch.from_numpy(b["block_tables"]), torch.from_numpy(b["tok_slot"]),
        torch.from_numpy(b["tok_pos"]))
    live = b["tok_pos"] >= 0
    _close(np.asarray(r_out)[0, live], t_out[0].detach().numpy()[live])
    for k in ("c", "kr"):
        _close(np.asarray(r_c[k])[1:], t_c[k][1:])


def test_flash_wrapper_takes_a_narrower_v_on_the_cpu():
    """q / k 48 wide, v 32 wide (the reduced MLA's heads): the forward
    equals the reference's blockwise_attention at MLA's scale, and the
    gradients its jax.vjp."""
    rng = np.random.default_rng(4)
    B, S, H, D, Dv = 2, 45, 4, 48, 32
    q, k = (rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    do = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    scale = D ** -0.5
    r_o, vjp = jax.vjp(lambda a, b_, c: RA.blockwise_attention(
        a, b_, c, scale=scale, block_q=16), *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, scale=scale, block_q=16)
    assert o.shape == (B, S, H, Dv)
    _close(r_o, o)
    o.backward(torch.from_numpy(do))
    for want, got in zip(vjp(jnp.asarray(do)), (tq, tk, tv)):
        _close(want, got.grad)
    with pytest.raises(ValueError, match="wider"):
        ops.flash_attention(tk[..., :Dv], tk[..., :Dv], tv.new_zeros(
            (B, S, H, D)))


def test_bf16_kernel_rounding_points_at_d192():
    """The tensor-core kernels at D = 192 (32-row streamed tiles) on MLA's
    shape of v: 128 value columns padded with zeros to 192, emulated in
    torch; o and the gradients within chip_smoke's bf16 bounds of the plain
    versions at the unpadded width, and the padded columns of o and dV
    exactly zero."""
    rng = np.random.default_rng(12)
    B, S, H, D, Dv = 1, 90, 2, 192, 128
    q, k = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, S, H, Dv)).astype(
        np.float32)).to(torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, S, H, Dv)).astype(
        np.float32)).to(torch.bfloat16)
    pad = (0, D - Dv)
    vp, dop = torch.nn.functional.pad(v, pad), \
        torch.nn.functional.pad(do, pad)
    o, lse = TFA.emulate_tc_forward(q, k, vp, True)
    assert torch.count_nonzero(o[..., Dv:]) == 0
    r_o, r_lse = FA.flash_attention_plain(q, k, v)
    assert TFA._max_abs(o[..., :Dv], r_o) <= TFA.BF16_TOL
    assert TFA._max_abs(lse, r_lse) <= 1e-4
    dq, dk, dv = TFA.emulate_tc_backward(q, k, vp, o, lse, dop, True)
    assert torch.count_nonzero(dv[..., Dv:]) == 0
    plain = FA.flash_attention_bwd_plain(q, k, v, r_o, r_lse, do)
    for got, want in zip((dq, dk, dv[..., :Dv]), plain):
        assert TFA._rel(got, want) <= TFA.BF16_TOL


def test_mla_with_a_quantized_kv_dtype_raises():
    _, tcfg = _cfgs()
    for kv in ("int8", "fp8", "bf16"):
        with pytest.raises(NotImplementedError, match="GQA-only"):
            TM.init_paged_cache(tcfg, 8, 4, 2, kv_dtype=kv, device="cpu")
        with pytest.raises(NotImplementedError, match="GQA-only"):
            RM.init_paged_cache(ref_config(ARCH).reduced(), 8, 4, 2,
                                kv_dtype=kv)
    c = TM.init_paged_cache(tcfg, 8, 4, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in c["blocks"].items()} == {
        "c": (1, 8, 4, 32), "kr": (1, 8, 4, 16)}
