"""The tensor-core FFN of the fused dual-branch kernel for bf16
(``csrc/dual_branch.cu``, namespace ``ffn_tc``) emulated in torch on the
CPU at its rounding points, against the JAX package's fused Pallas kernel
(``fused_dual_branch_decode``, interpret mode) for swiglu, geglu and gelu at
B = 3 and B = 11 (two 8-row groups of the mma's N).

The kernel's arithmetic: per tile of ``FFN_TILE`` columns of F, x @ wi and
x @ wg from bf16 values (each product exact in fp32) summed in fp32;
h = act(g) * i in fp32, fed to wo as the bf16 pair hi = bf16(h),
lo = bf16(h - hi) (h to 2^-17); the tile's fp32 partial of y; partials
summed in tile order within ``FFN_SUM_CHUNKS`` chunks of tiles, the chunks
added in order, in fp32, y rounded to bf16 once.  Tolerances: the
unrounded emulation differs from the reference's fp32 arithmetic by the
order of its sums and the pair's 2^-17, so 1e-5 at these widths; the
rounded one is within one bf16 ulp of the largest |y| of the reference's
bf16 output (both round once, from fp32 values ~1e-6 apart)."""
import math
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.kernels import dual_branch as RDB  # noqa: E402
from repro_torch.kernels import dual_branch as DB  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL_FP32 = 1e-5
HKV, TB, PAGE = 2, 4, 8


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _act(kind, g):
    """The kernel's activations: silu, and jax.nn.gelu's tanh form."""
    if kind == "swiglu":
        return g / (1.0 + torch.exp(-g))
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * g * (1.0 + torch.tanh(c * (g + 0.044715 * g ** 3)))


def emulate_ffn_tiles(x, ffn, kind, *, round_y=True):
    """y (B, Dm) as the tensor-core FFN blocks and the finishing kernel
    compute it, from bf16-valued fp32 x (B, Dm) and weights."""
    F = ffn["wi"].shape[1]
    parts = []
    for f0 in range(0, F, DB.FFN_TILE):
        cols = slice(f0, min(f0 + DB.FFN_TILE, F))
        i = x @ ffn["wi"][:, cols]
        h = _act(kind, i) if kind == "gelu" else \
            _act(kind, x @ ffn["wg"][:, cols]) * i
        hi = _bf16(h)
        lo = _bf16(h - hi)
        wo = ffn["wo"][cols]
        parts.append(hi @ wo + lo @ wo)      # the tile's partial
    per = -(-len(parts) // DB.FFN_SUM_CHUNKS)
    y = torch.zeros(x.shape[0], ffn["wo"].shape[1])
    for c in range(0, len(parts), per):     # chunks in order
        chunk = torch.zeros_like(y)
        for part in parts[c:c + per]:       # tiles in order within a chunk
            chunk = chunk + part
        y = y + chunk
    return _bf16(y) if round_y else y


def _case(kind, B, F, Dm, seed):
    """bf16-valued numpy inputs of the JAX fused kernel: attention at small
    widths (Hkv * Tb = 8 tiles, so F % 8 == 0) and an FFN at
    ``layers.dense_init``'s scales."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0):
        x = torch.from_numpy((rng.standard_normal(shape) * std)
                             .astype(np.float32))
        return _bf16(x).numpy()

    P = B * TB + 1
    bt = rng.permutation(np.arange(1, P))[:B * TB].reshape(B, TB)
    att = (rnd(B, 3 * HKV, 32), rnd(P, PAGE, HKV, 32),
           rnd(P, PAGE, HKV, 32), bt.astype(np.int32),
           rng.integers(1, TB * PAGE + 1, B).astype(np.int32))
    ffn = {"wi": rnd(Dm, F, std=Dm ** -0.5), "wo": rnd(F, Dm, std=F ** -0.5)}
    if kind != "gelu":
        ffn["wg"] = rnd(Dm, F, std=Dm ** -0.5)
    return att, rnd(B, Dm), ffn


def _bf16_ulp(ref):
    top = max(float(np.abs(ref).max()), 2.0 ** -126)
    return 2.0 ** (math.floor(math.log2(top)) - 7)


#: F = 200: a ragged last tile (200 = 3 x 64 + 8); Dm = 96 and 104: stages
#: of 64 rows and 128 columns that end short
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("B,F,Dm", [(3, 256, 96), (11, 200, 104)])
def test_tile_emulation_matches_pallas(kind, B, F, Dm):
    att, x, ffn = _case(kind, B, F, Dm, seed=B * F + len(kind))
    tx = torch.from_numpy(x)
    tw = {k: torch.from_numpy(v) for k, v in ffn.items()}
    # fp32 reference: the Pallas kernel (interpret mode) on the bf16 values
    _, y32 = RDB.fused_dual_branch_decode(
        *[jnp.asarray(a) for a in att], jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in ffn.items()}, kind=kind,
        interpret=True)
    exact = emulate_ffn_tiles(tx, tw, kind, round_y=False)
    np.testing.assert_allclose(exact.numpy(), np.asarray(y32), atol=TOL_FP32,
                               rtol=0)
    # bf16 in and out, as the serving path calls it: one rounding each side
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)           # noqa: E731
    _, y16 = RDB.fused_dual_branch_decode(
        *[bf(a) for a in att[:3]], *map(jnp.asarray, att[3:]), bf(x),
        {k: bf(v) for k, v in ffn.items()}, kind=kind, interpret=True)
    y16 = np.asarray(y16.astype(jnp.float32))
    emu = emulate_ffn_tiles(tx, tw, kind)
    assert torch.equal(emu, _bf16(emu))
    err = np.abs(emu.numpy() - y16).max()
    assert err <= _bf16_ulp(y16), (err, _bf16_ulp(y16))
    # and the port's plain version (mlp_apply in fp32 on the same values)
    plain = L.mlp_apply(tw, tx[:, None], kind)[:, 0]
    np.testing.assert_allclose(exact.numpy(), plain.numpy(), atol=TOL_FP32,
                               rtol=0)


def test_the_hi_lo_pair_carries_h_to_2_pow_minus_17():
    """bf16(h) + bf16(h - bf16(h)) is h within 2^-17 |h| (relative), where
    one rounding leaves up to 2^-9."""
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 3
    hi = _bf16(h)
    pair = hi + _bf16(h - hi)
    assert ((pair - h).abs() <= h.abs() * 2.0 ** -17).all()
    assert ((hi - h).abs() > h.abs() * 2.0 ** -12).any()


def test_tile_constants_mirror_the_kernel_source():
    """FFN_TILE is the kernel's kFT, in both routes of dual_branch.cu, and
    FFN_SUM_CHUNKS its kSumChunks."""
    src = (pathlib.Path(DB.__file__).parent / "csrc"
           / "dual_branch.cu").read_text()
    tiles = re.findall(r"constexpr int kFT = (\d+);", src)
    assert len(tiles) == 2 and all(int(t) == DB.FFN_TILE for t in tiles)
    chunks = re.findall(r"constexpr int kSumChunks = (\d+);", src)
    assert [int(c) for c in chunks] == [DB.FFN_SUM_CHUNKS]


@pytest.mark.cuda
def test_fused_kernel_matches_the_emulation_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for kind in DB.KINDS:
        for B, F, Dm in ((3, 256, 96), (11, 200, 104), (8, 256, 100)):
            att, x, ffn = _case(kind, B, F, Dm, seed=B)
            card = [torch.from_numpy(a).cuda() for a in att]
            card[:3] = [a.to(torch.bfloat16) for a in card[:3]]
            tx = torch.from_numpy(x)
            tw = {k: torch.from_numpy(v) for k, v in ffn.items()}
            _, y = DB.fused_dual_branch_decode(
                *card, tx.cuda().to(torch.bfloat16),
                {k: v.cuda().to(torch.bfloat16) for k, v in tw.items()},
                kind=kind)
            emu = emulate_ffn_tiles(tx, tw, kind)
            err = (y.float().cpu() - emu).abs().max().item()
            assert err <= _bf16_ulp(emu.numpy())
