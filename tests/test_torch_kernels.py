"""The port's paged-attention kernel module: its plain version against the
JAX package's Pallas kernel (interpret mode) and oracle, its dispatcher
telemetry and argument checks, the build recipe, and (on a card only) the
CUDA kernel against the plain version."""
import itertools
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import paged_attention as RPA  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

TOL = 1e-5          # fp32 on both sides; softmax sums in another order
ROOT = pathlib.Path(__file__).resolve().parents[1]
_REF = jax.jit(RREF.paged_packed_attention_ref)


def _packed_case(page, D, G, Hkv=2, seed=0):
    """A ragged packed tick: a multi-token prefill segment, a segment that
    starts mid-sequence, single decode tokens and padding rows."""
    rng = np.random.default_rng(seed)
    S, Tb, P = 4, 40 // page + 2, 64
    H = G * Hkv
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = np.zeros((S, Tb), np.int32)
    bt[:, :Tb - 1] = rng.permutation(np.arange(1, P))[:S * (Tb - 1)] \
        .reshape(S, Tb - 1)
    tok_slot = [0] * 5 + [1] * 3 + [2, 3] + [0] * 3
    tok_pos = list(range(5)) + [17, 18, 19] + [33, 8] + [-1] * 3
    q = rng.standard_normal((len(tok_slot), H, D)).astype(np.float32)
    return q, kp, vp, bt, np.array(tok_slot, np.int32), \
        np.array(tok_pos, np.int32)


def _torch(args):
    return [torch.from_numpy(a) for a in args]


def _check_padding(out, tok_pos):
    pad = tok_pos < 0
    assert pad.any()
    assert np.all(out[pad] == 0.0)


@pytest.mark.parametrize("page,D,G", list(itertools.product(
    (4, 8, 16), (32, 64, 128), (1, 2, 3, 4))))
def test_plain_matches_oracle_and_pallas_interpret(page, D, G):
    args = _packed_case(page, D, G, seed=page * D + G)
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(_REF(*jargs))
    pallas = np.asarray(RPA.paged_packed_attention(*jargs, interpret=True))
    out = ops.paged_packed_attention(*_torch(args)).numpy()
    live = args[-1] >= 0
    np.testing.assert_allclose(out[live], ref[live], atol=TOL, rtol=0)
    np.testing.assert_allclose(out[live], pallas[live], atol=TOL, rtol=0)
    _check_padding(out, args[-1])
    assert np.all(pallas[~live] == 0.0)


def test_plain_keeps_query_dtype():
    args = _torch(_packed_case(8, 32, 3))
    q = args[0].to(torch.bfloat16)
    out = PA.paged_packed_attention(q, *args[1:])
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_dispatch_records_executed_cpu_calls():
    ops.reset_dispatch_paths()
    name = "kernel_dispatch_total.paged_packed_attention.cpu-plain"
    before = metrics.default_registry().counter(name).value
    launches = PA.LAUNCHES
    args = _torch(_packed_case(4, 32, 2))
    for _ in range(3):
        ops.paged_packed_attention(*args)
    assert ops.dispatch_paths() == {"paged_packed_attention": ops.PLAIN}
    assert metrics.default_registry().counter(name).value == before + 3
    assert PA.LAUNCHES == launches          # the plain version never counts


def test_scale_pools_raise():
    args = _torch(_packed_case(4, 32, 2))
    scale = torch.ones(64, 4)
    with pytest.raises(NotImplementedError, match="quantized-KV slice"):
        ops.paged_packed_attention(*args, k_scale=scale, v_scale=scale)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    args = _torch(_packed_case(4, 32, 2))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        PA.check_kernel_args(*args)
    # the CUDA entry checks before it builds or launches anything
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_packed_attention_cuda(*args)


def test_build_recipe(monkeypatch):
    assert set(p.stem for p in build.CSRC.glob("*.cu")) == {"paged_attention"}
    cmd = build.nvcc_command("nvcc", "paged_attention",
                             build.BUILD_DIR / "x.so")
    flags = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in cmd and "-fPIC" in cmd and "-O3" in cmd
    assert build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    path = build.library_path("paged_attention")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert build.library_path("paged_attention") == path
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_port_imports_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro(\.| import))", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python3 "
                    "chip_smoke.py or pytest -m cuda)")
    for (page, D, G), dtype in itertools.product(
            ((4, 32, 1), (8, 64, 3), (16, 128, 3), (16, 128, 4)),
            (torch.float32, torch.bfloat16)):
        args = [t.cuda() for t in _torch(_packed_case(page, D, G))]
        q, kp, vp = (t.to(dtype) for t in args[:3])
        out = PA.paged_packed_attention(q, kp, vp, *args[3:])
        ref = PA.paged_packed_attention_plain(q.float(), kp.float(),
                                              vp.float(), *args[3:])
        torch.cuda.synchronize()
        # fp32: sums in another order; bf16: one output rounding
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        live = args[-1] >= 0
        err = (out[live].float() - ref.to(dtype)[live].float()).abs().max()
        assert err.item() <= tol
        assert out[~live].abs().max().item() == 0.0
