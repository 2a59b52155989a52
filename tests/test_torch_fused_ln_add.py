"""The port's fused LN-add module: its plain version against
``ref.ln_add_ref`` and the Pallas kernel in interpret mode (rmsnorm and
layernorm, fp32 and bf16), its gradients against ``jax.grad``, the forward
kernel's per-row reduction order (``csrc/fused_ln_add.cu``: a row's
vectors over a fixed group of threads, an xor butterfly in each warp, the
warps' sums in order) emulated in torch against ``ref.ln_add_ref`` and the
Pallas kernel, and its launch rule, the backward kernel's reduction order
(per-block partial rows over a fixed set of rows, then column sums in a
fixed two-level order) emulated in torch against ``jax.grad``, FAL's MLP
inputs in ``core/fal.py`` (which now run it) against the reference's for
all six connection modes, and (on a card only) the CUDA kernels against
the plain version.

Tolerances: fp32 1e-6 (one rsqrt and a few products, values of order 1);
bf16 one bf16 ulp of the largest output (the same fp32 value rounded once
on each side, after sums in another order)."""
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.core import fal as RF  # noqa: E402
from repro.kernels import fused_ln_add as RLN  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import fal as TF  # noqa: E402
from repro_torch.kernels import fused_ln_add as LN  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-6


def _case(kind, rows=37, d=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32) * 2 + 0.5
    a1 = rng.standard_normal((rows, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32) \
        if kind == "layernorm" else None
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    return x, a1, scale, bias, dy


def _bf16_ulp(a):
    top = float(np.abs(np.asarray(a, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_and_pallas(kind, dtype):
    x, a1, scale, bias, _ = _case(kind, seed=len(kind))
    jx, ja = (jnp.asarray(t).astype(dtype) for t in (x, a1))
    jb = None if bias is None else jnp.asarray(bias)
    tx, ta = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in (x, a1))
    got = LN.ln_add_plain(tx, ta, torch.from_numpy(scale),
                          None if bias is None else torch.from_numpy(bias),
                          kind=kind).float().numpy()
    refs = (RREF.ln_add_ref(jx, ja, jnp.asarray(scale), jb, kind=kind),
            RLN.fused_ln_add(jx, ja, jnp.asarray(scale), jb, kind=kind,
                             block_rows=16, interpret=True))
    for ref in refs:
        ref = np.asarray(ref.astype(jnp.float32))
        tol = TOL if dtype == "float32" else _bf16_ulp(ref)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_gradients_match_jax_grad(kind):
    """d/d(x, a1n, scale, bias) of sum(y * dy): autograd through the plain
    version (the dispatcher's CPU path) against jax.grad of ln_add_ref."""
    x, a1, scale, bias, dy = _case(kind, seed=7)
    args = [x, a1, scale] + ([bias] if bias is not None else [])

    def ref_loss(*a):
        b = a[3] if len(a) > 3 else None
        return jnp.sum(RREF.ln_add_ref(a[0], a[1], a[2], b, kind=kind)
                       * jnp.asarray(dy))
    want = jax.grad(ref_loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ops.reset_dispatch_paths()
    y = ops.fused_ln_add(leaves[0], leaves[1], leaves[2],
                         leaves[3] if bias is not None else None, kind=kind)
    y.backward(torch.from_numpy(dy))
    assert ops.dispatch_paths() == {"fused_ln_add": ops.PLAIN}
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-4 if leaf.dim() == 1 else 1e-5,
                                   rtol=0)


def _cu_constants(*names):
    """Integer constants of ``csrc/fused_ln_add.cu``."""
    src = (pathlib.Path(LN.__file__).parent / "csrc" / "fused_ln_add.cu")
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                            src.read_text()))
    return {k: int(const[k]) for k in names}


def _bwd_constants():
    """The backward's grid and column-sum constants from its source."""
    return _cu_constants("kBwdPerSM", "kSumThreads", "kMaxThreads")


_FWD = ("kFwdWarpVecs", "kFwdVecs", "kFwdMaxWarps", "kFwdBlockThreads")


def fwd_launch(rows, nv, sms):
    """The forward's launch rule (``fwd_row_threads`` and ``fwd`` in the
    source), from its constants: (threads a row T, vectors a thread NV,
    rows a block R, blocks).  T and NV follow from a row's nv vectors
    alone: one warp while it holds the row in kFwdWarpVecs vectors a
    thread, else warps for kFwdVecs a thread, at most kFwdMaxWarps; R (a
    power of two) only while R groups fit a many-row block and the blocks
    still number at least ``sms``."""
    c = _cu_constants(*_FWD)
    t = 32 if nv <= 32 * c["kFwdWarpVecs"] else \
        32 * min(-(-nv // (32 * c["kFwdVecs"])), c["kFwdMaxWarps"])
    R = 1
    while 2 * R * t <= c["kFwdBlockThreads"] and -(-rows // (2 * R)) >= sms:
        R *= 2
    return t, -(-nv // t), R, -(-rows // R)


def _fma(a, b, c):
    """fp32 fma(a, b, c): the exact product and sum in fp64, rounded once
    to fp32 (a double rounding, not the card's single one, in rare
    halfway cases)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_ln_add_fwd(x, a1n, scale, bias, kind, *, vec, eps=1e-6):
    """The forward kernel's arithmetic and order on (rows, d) inputs in
    their dtype, with rows of ``vec``-value vectors: thread t of a row's T
    sums the values of its vectors t, t + T, ... in vector order (fmaf of
    the squares for rmsnorm); each warp adds its 32 lanes in an xor
    butterfly, the row adds its warps' sums in warp order; layernorm takes
    the mean that way, then the mean square about it from the same values.
    Returns (y in x's dtype, mean, rstd)."""
    rows, d = x.shape
    nv = d // vec
    t, n, _, _ = fwd_launch(rows, nv, sms=1)
    xf = x.float()
    ln = kind == "layernorm"

    def row_sum(vals, square):
        # (rows, d) -> (rows, T, NV * vec) in each thread's order
        pad = torch.zeros(rows, n * t * vec)
        pad[:, :d] = vals
        per = pad.view(rows, n, t, vec).permute(0, 2, 1, 3).reshape(
            rows, t, n * vec)
        acc = torch.zeros(rows, t)
        for i in range(n * vec):
            v = per[:, :, i]
            acc = _fma(v, v, acc) if square else acc + v
        lanes = acc.view(rows, t // 32, 32)
        for o in (16, 8, 4, 2, 1):
            lanes = lanes[..., :o] + lanes[..., o:2 * o]
        s = lanes[..., 0]
        out = s[:, 0]
        for w in range(1, t // 32):
            out = out + s[:, w]
        return out

    if ln:
        mu = row_sum(xf, False) / d
        var = row_sum(xf - mu[:, None], True) / d
    else:
        mu = torch.zeros(rows)
        var = row_sum(xf, True) / d
    rstd = torch.rsqrt(var + eps)
    if ln:
        n_ = _fma((xf - mu[:, None]) * rstd[:, None], scale, bias)
    else:
        n_ = xf * rstd[:, None] * scale
    return (n_ + a1n.float()).to(x.dtype), mu, rstd


#: (vector width, dtype) of a row of width d: 16-byte vectors where d
#: allows (8 bf16 or 4 fp32 values), else halves down to one value
def _vec(d, dtype):
    vec = 8 if dtype == "bfloat16" else 4
    while d % vec:
        vec //= 2
    return vec


@pytest.mark.parametrize("d", [3072, 768, 200, 1001])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_reduction_order_matches_reference(d, kind, dtype):
    """The forward kernel's per-row order (one warp a row at d = 768 bf16
    and d = 200; 3 to 16 warps at 768 fp32, 1001 and 3072) against
    ``ref.ln_add_ref`` and the Pallas kernel in interpret mode: fp32 within
    1e-5, bf16 within one bf16 ulp of the largest output (one rounding of
    fp32 values a few ulps apart)."""
    x, a1, scale, bias, _ = _case(kind, rows=13, d=d, seed=d)
    jx, ja = (jnp.asarray(t).astype(dtype) for t in (x, a1))
    jb = None if bias is None else jnp.asarray(bias)
    tx, ta = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in (x, a1))
    got, _, _ = emulate_ln_add_fwd(
        tx, ta, torch.from_numpy(scale),
        None if bias is None else torch.from_numpy(bias), kind,
        vec=_vec(d, dtype))
    got = got.float().numpy()
    refs = (RREF.ln_add_ref(jx, ja, jnp.asarray(scale), jb, kind=kind),
            RLN.fused_ln_add(jx, ja, jnp.asarray(scale), jb, kind=kind,
                             block_rows=8, interpret=True))
    for ref in refs:
        ref = np.asarray(ref.astype(jnp.float32))
        tol = 1e-5 if dtype == "float32" else _bf16_ulp(ref)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("kind,d", [("rmsnorm", 3072), ("layernorm", 768)])
def test_forward_row_bits_do_not_depend_on_row_count(kind, d):
    """A row's threads and order come from d alone: at 263 rows (the
    engine's token budget), 8 (a padded decode tick) and 1 row the launch
    keeps T and NV, and the emulated rows 0..7 have the same bits.  The
    emulation computes each row on its own, so this holds the launch plan
    to the property; the kernel itself is held to it on the card
    (``test_forward_without_statistics_on_card`` and chip_smoke.py)."""
    x, a1, scale, bias, _ = _case(kind, rows=263, d=d, seed=3)
    tx, ta = (torch.from_numpy(t).bfloat16() for t in (x, a1))
    sc = torch.from_numpy(scale)
    bi = None if bias is None else torch.from_numpy(bias)
    nv = d // 8
    plans = {rows: fwd_launch(rows, nv, sms=132) for rows in (1, 8, 263)}
    assert len({p[:2] for p in plans.values()}) == 1
    full = emulate_ln_add_fwd(tx, ta, sc, bi, kind, vec=8)
    for rows in (8, 1):
        part = emulate_ln_add_fwd(tx[:rows], ta[:rows], sc, bi, kind, vec=8)
        for a, b in zip(part, full):
            assert torch.equal(a, b[:rows])


def test_forward_launch_rule():
    """The constants of the forward's launch rule in the source, and what
    they give at the port's shapes on a 132-SM card: d = 3072 bf16 six
    warps a row of 2 vectors each, a row a block; d = 768 bf16 one warp a
    row of 3 (no barrier), eight rows a block at 2048 rows, two at 263,
    one at 8; fp32 d = 3072 twelve warps; d = 8191 (one-value vectors) 16
    warps of 16."""
    assert _cu_constants(*_FWD) == {"kFwdWarpVecs": 3, "kFwdVecs": 2,
                                    "kFwdMaxWarps": 16,
                                    "kFwdBlockThreads": 256}
    assert fwd_launch(263, 384, 132) == (192, 2, 1, 263)
    assert fwd_launch(8, 384, 132) == (192, 2, 1, 8)
    assert fwd_launch(2048, 384, 132) == (192, 2, 1, 2048)
    assert fwd_launch(2048, 96, 132) == (32, 3, 8, 256)
    assert fwd_launch(263, 96, 132) == (32, 3, 2, 132)
    assert fwd_launch(8, 96, 132) == (32, 3, 1, 8)
    assert fwd_launch(2048, 768, 132) == (384, 2, 1, 2048)
    assert fwd_launch(3, 8191, 132) == (512, 16, 1, 3)
    assert fwd_launch(3, 128, 132) == (64, 2, 1, 3)     # d = 1024 bf16


def emulate_ln_add_bwd(dy, x, scale, kind, *, sms, eps=1e-6):
    """The backward kernels' arithmetic and order on fp32 (rows, d) inputs,
    for a card of ``sms`` SMs: dx per row; block i of min(rows, kBwdPerSM x
    sms) sums dy * xhat (and dy) over rows i, i + grid, ... in row order
    into its partial row; the column sums add partial rows rg, rg + RG, ...
    in order (RG = kSumThreads / CU, CU the column units of a block: the
    most, up to 32, that leave at least ``sms`` blocks), then the RG sums
    in a halving tree.  Returns (dx, dscale, dbias)."""
    c = _bwd_constants()
    rows, d = x.shape
    ln = kind == "layernorm"
    mu = x.mean(-1) if ln else torch.zeros(rows)
    xc = x - mu[:, None]
    rs = torch.rsqrt((xc * xc).mean(-1) + eps)
    xh = xc * rs[:, None]
    g = dy * scale
    m_gx = (g * xh).sum(-1) / d
    m_g = g.sum(-1) / d if ln else torch.zeros(rows)
    dx = rs[:, None] * (g - m_g[:, None] - xh * m_gx[:, None])
    grid = min(rows, c["kBwdPerSM"] * sms)
    U = 4 if d % 4 == 0 else 1
    CU = 1
    while CU < 32 and -(-d // (2 * U * CU)) >= sms:
        CU *= 2
    RG = c["kSumThreads"] // CU

    def reduce(terms):
        part = torch.zeros(grid, d)
        for r0 in range(0, rows, grid):        # each block's next row
            n = min(grid, rows - r0)
            part[:n] += terms[r0:r0 + n]
        sums = torch.zeros(RG, d)
        for p0 in range(0, grid, RG):          # each thread's next row
            n = min(RG, grid - p0)
            sums[:n] += part[p0:p0 + n]
        h = RG // 2
        while h:
            sums[:h] += sums[h:2 * h]
            h //= 2
        return sums[0]

    return dx, reduce(dy * xh), reduce(dy) if ln else None


@pytest.mark.parametrize("kind,rows,d", [("rmsnorm", 600, 3072),
                                         ("layernorm", 37, 96),
                                         ("layernorm", 300, 1001)])
def test_backward_reduction_order_matches_jax_grad(kind, rows, d):
    """The kernel's order (grid of 264 partial rows on a 132-SM card, or
    fewer rows than that; 16-byte and one-column units) against jax.grad
    of ln_add_ref: dx within 1e-5, dscale / dbias within 1e-4 (sums of a
    few hundred order-1 products in another order)."""
    x, a1, scale, bias, dy = _case(kind, rows=rows, d=d, seed=rows)
    args = [x, a1, scale] + ([bias] if bias is not None else [])

    def ref_loss(*a):
        b = a[3] if len(a) > 3 else None
        return jnp.sum(RREF.ln_add_ref(a[0], a[1], a[2], b, kind=kind)
                       * jnp.asarray(dy))
    want = jax.grad(ref_loss, argnums=(0, 2) + ((3,) if bias is not None
                                                else ()))(
        *map(jnp.asarray, args))
    got = emulate_ln_add_bwd(*(torch.from_numpy(t) for t in (dy, x, scale)),
                             kind, sms=132)
    for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=0)


def test_backward_constants():
    """Two blocks an SM, 256-thread rows and column-sum blocks: the numbers
    the emulation above and chip_smoke.py's timing notes assume."""
    assert _bwd_constants() == {"kBwdPerSM": 2, "kSumThreads": 256,
                                "kMaxThreads": 256}


def _norm_params(rng, d, kind):
    p = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return p


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gpt2-117m"])
@pytest.mark.parametrize("mode", ["preln", "parallel", "fal", "falplus",
                                  "ablation1", "ablation2"])
def test_fal_mlp_inputs_match_reference(arch, mode):
    """``mlp_input`` and ``block0_mlp_input`` of every connection mode from
    the same x, a, a1 and random norm parameters: equal to the reference's
    in fp32 within 1e-6, and ``fused_ln_add`` recorded exactly for the modes
    that sum an LN with something."""
    rcfg = ref_config(arch).reduced().replace(connection=mode)
    tcfg = get_config(arch).reduced().replace(connection=mode)
    rng = np.random.default_rng(11)
    d = rcfg.d_model
    p = {name: _norm_params(rng, d, rcfg.norm)
         for name in ("ln2", "ln_fal", "ln_a")}
    x, a, a1 = (rng.standard_normal((2, 5, d)).astype(np.float32)
                for _ in range(3))
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: {n: torch.from_numpy(v) for n, v in q.items()}
          for k, q in p.items()}
    j, t = (lambda *z: [jnp.asarray(v) for v in z]), \
        (lambda *z: [torch.from_numpy(v) for v in z])
    r_sig = RF.first_attention_signal(rcfg, jp, *j(a1))
    t_sig = TF.first_attention_signal(tcfg, tp, *t(a1))
    ops.reset_dispatch_paths()
    pairs = [(RF.block0_mlp_input(rcfg, jp, *j(x, a)),
              TF.block0_mlp_input(tcfg, tp, *t(x, a))),
             (RF.mlp_input(rcfg, jp, *j(x, a), r_sig),
              TF.mlp_input(tcfg, tp, *t(x, a), t_sig))]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0)
    assert set(ops.dispatch_paths()) == (
        {"fused_ln_add"} if mode in TF.FUSED_LN_ADD_MODES else set())


def test_bf16_rounds_the_sum_once():
    """In bf16 fal's ``ln2(x) + a1`` is rounded once by the fused path and
    twice by the reference's jnp (LN(x), then the sum); the two stay within
    one bf16 ulp of the larger of |LN(x)| and the sum."""
    rcfg = ref_config("llama3.2-3b").reduced().replace(connection="fal",
                                                       dtype="bfloat16")
    tcfg = get_config("llama3.2-3b").reduced().replace(connection="fal",
                                                       dtype="bfloat16")
    rng = np.random.default_rng(5)
    p = {"ln2": _norm_params(rng, rcfg.d_model, "rmsnorm")}
    x, a1 = (rng.standard_normal((4, 9, rcfg.d_model)).astype(np.float32)
             for _ in range(2))
    ref = RF.mlp_input(rcfg, jax.tree.map(jnp.asarray, p),
                       jnp.asarray(x, jnp.bfloat16), None,
                       jnp.asarray(a1, jnp.bfloat16))
    got = TF.mlp_input(tcfg, {"ln2": {"scale": torch.from_numpy(
        p["ln2"]["scale"])}}, torch.from_numpy(x).bfloat16(), None,
        torch.from_numpy(a1).bfloat16())
    ref = np.asarray(ref.astype(jnp.float32))
    xb = jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
    ln = np.asarray(RREF.ln_add_ref(xb, jnp.zeros_like(xb),
                                    jnp.asarray(p["ln2"]["scale"])))
    top = np.maximum(np.maximum(np.abs(ref), np.abs(ln)), 2.0 ** -126)
    diff = np.abs(got.float().numpy() - ref)
    assert np.all(diff <= 2.0 ** (np.floor(np.log2(top)) - 7))
    assert np.any(diff > 0)             # the roundings do differ somewhere


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    x, a1, scale, _, dy = (None if t is None else torch.from_numpy(t)
                           for t in _case("rmsnorm"))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        LN.fused_ln_add_fwd_cuda(x, a1, scale)
    with pytest.raises(ValueError, match="kind"):
        LN.check_kernel_args(x, scale, "batchnorm")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for kind, rows, d in (("rmsnorm", 64, 3072), ("layernorm", 37, 768),
                          ("rmsnorm", 5, 1001), ("rmsnorm", 600, 3072),
                          ("layernorm", 300, 1001)):
        x, a1, scale, bias, dy = (None if t is None else
                                  torch.from_numpy(t).cuda()
                                  for t in _case(kind, rows, d))
        leaves = [t.clone().requires_grad_(True) for t in (x, scale)]
        ref = LN.ln_add_plain(leaves[0], a1, leaves[1], bias, kind=kind)
        ref.backward(dy)
        y, mean, rstd = LN.fused_ln_add_fwd_cuda(x, a1, scale, bias,
                                                 kind=kind)
        dx, dscale, _ = LN.fused_ln_add_bwd_cuda(dy, x, scale, mean, rstd,
                                                 kind=kind)
        again = LN.fused_ln_add_bwd_cuda(dy, x, scale, mean, rstd,
                                         kind=kind)
        emu = emulate_ln_add_bwd(dy.cpu(), x.cpu(), scale.cpu(), kind,
                                 sms=torch.cuda.get_device_properties(
                                     0).multi_processor_count)
        torch.cuda.synchronize()
        assert (y - ref).abs().max().item() <= 1e-5
        assert (dx - leaves[0].grad).abs().max().item() <= 1e-4
        assert (dscale - leaves[1].grad).abs().max().item() <= 1e-3
        assert torch.equal(dx, again[0]) and torch.equal(dscale, again[1])
        assert (dscale.cpu() - emu[1]).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_forward_without_statistics_on_card():
    """The serving route (no statistics written or allocated) gives y's
    bits; ``fused_ln_add`` takes it with no gradient to compute, and the
    autograd Function (statistics saved) otherwise; the emulated order
    stays within 1e-5 of the kernel in fp32.  In bf16 a row's bits do not
    depend on the row count: rows 0..7 of a 263-row rmsnorm call and of a
    2048-row layernorm call (8 rows a block at d = 768) equal an 8-row and
    a 1-row call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for kind, rows, d in (("rmsnorm", 263, 3072), ("layernorm", 8, 768),
                          ("rmsnorm", 5, 1001)):
        x, a1, scale, bias = (None if t is None else
                              torch.from_numpy(t).cuda()
                              for t in _case(kind, rows, d)[:4])
        y, mean, rstd = LN.fused_ln_add_fwd_cuda(x, a1, scale, bias,
                                                 kind=kind)
        bare, m2, r2 = LN.fused_ln_add_fwd_cuda(x, a1, scale, bias,
                                                kind=kind, stats=False)
        with torch.no_grad():
            served = LN.fused_ln_add(x, a1, scale, bias, kind=kind)
        emu = emulate_ln_add_fwd(x.cpu(), a1.cpu(), scale.cpu(),
                                 None if bias is None else bias.cpu(), kind,
                                 vec=_vec(d, "float32"))
        torch.cuda.synchronize()
        assert m2 is None and r2 is None
        assert torch.equal(bare, y) and torch.equal(served, y)
        assert (y.cpu() - emu[0]).abs().max().item() <= 1e-5
        assert (rstd.cpu() - emu[2]).abs().max().item() <= 1e-5
    for kind, rows, d in (("rmsnorm", 263, 3072), ("layernorm", 2048, 768)):
        x, a1, scale, bias = (None if t is None else
                              torch.from_numpy(t).cuda()
                              for t in _case(kind, rows, d, seed=5)[:4])
        x, a1 = x.bfloat16(), a1.bfloat16()
        full = LN.fused_ln_add_fwd_cuda(x, a1, scale, bias, kind=kind,
                                        stats=False)[0]
        for n in (8, 1):
            part = LN.fused_ln_add_fwd_cuda(x[:n], a1[:n], scale, bias,
                                            kind=kind, stats=False)[0]
            assert torch.equal(part, full[:n])
