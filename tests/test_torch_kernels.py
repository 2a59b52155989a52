"""The port's paged-attention kernel module: its plain version against the
JAX package's Pallas kernel (interpret mode) and oracle, its dispatcher
telemetry and argument checks, the build recipe, and (on a card only) the
CUDA kernel against the plain version."""
import itertools
import pathlib
import re
import shutil
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

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
    launches = dict(PA.LAUNCHES)
    args = _torch(_packed_case(4, 32, 2))
    for _ in range(3):
        ops.paged_packed_attention(*args)
    assert ops.dispatch_paths() == {"paged_packed_attention": ops.PLAIN}
    assert metrics.default_registry().counter(name).value == before + 3
    assert PA.LAUNCHES == launches          # the plain version never counts


def test_scale_pools_raise():
    """Scale pools no longer raise: int8 pools with (P, page) row scales run
    the plain scale variant on the CPU, equal to the unquantized plain
    version on the dequantized pools, under the ``.int8`` site label."""
    q, kp, vp, *idx = _torch(_packed_case(4, 32, 2))
    ks = torch.rand(64, 4) / 64 + 1e-3
    vs = torch.rand(64, 4) / 64 + 1e-3
    k8 = (kp * 40).round().clamp(-127, 127).to(torch.int8)
    v8 = (vp * 40).round().clamp(-127, 127).to(torch.int8)
    ops.reset_dispatch_paths()
    out = ops.paged_packed_attention(q, k8, v8, *idx, k_scale=ks, v_scale=vs)
    want = PA.paged_packed_attention_plain(
        q, k8.float() * ks[..., None, None], v8.float() * vs[..., None, None],
        *idx)
    assert torch.equal(out, want)
    assert ops.dispatch_paths() == {"paged_packed_attention.int8": ops.PLAIN}


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    args = _torch(_packed_case(4, 32, 2))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        PA.check_kernel_args(*args)
    # the CUDA entry checks before it builds or launches anything
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_packed_attention_cuda(*args)


def test_build_recipe(monkeypatch):
    assert set(p.stem for p in build.CSRC.glob("*.cu")) == {
        "paged_attention", "dual_branch", "page_copy", "flash_attention",
        "fused_ln_add"}
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


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header under csrc/ changes the library path of every
    source that includes it (so it is rebuilt), and of no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("paged_attention", "dual_branch")
    header = csrc / "paged_common.cuh"
    # the bf16 key-split decode's header, and the Hopper helpers it
    # includes
    assert build.local_includes(csrc / "dual_branch.cu") == [
        header, csrc / "paged_decode_splits.cuh", csrc / "sm90_common.cuh"]
    # also the tensor-core packed kernel's header
    assert build.local_includes(csrc / "paged_attention.cu") == [
        header, csrc / "paged_decode_splits.cuh", csrc / "paged_packed_tc.cuh",
        csrc / "sm90_common.cuh"]
    before = {n: build.library_path(n) for n in names}
    (csrc / "unused.cuh").write_text("// included by nothing\n")
    assert {n: build.library_path(n) for n in names} == before
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(after[n].parent == build.BUILD_DIR for n in names)


def test_flash_attention_build_hashes_the_hopper_header(tmp_path,
                                                        monkeypatch):
    """flash_attention.cu includes csrc/sm90_common.cuh (the TMA, mbarrier
    and wgmma helpers of its bf16 kernels), and so do paged_attention.cu
    through csrc/paged_packed_tc.cuh (the tensor-core packed kernel) and
    csrc/paged_decode_splits.cuh (the key-split decode), dual_branch.cu (its
    TMA-fed FFN and the key-split items) and fused_ln_add.cu (the
    backward's programmatic dependent launch): editing that header rebuilds
    those four libraries and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    header = csrc / "sm90_common.cuh"
    assert build.local_includes(csrc / "flash_attention.cu") == [header]
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    before = {n: build.library_path(n) for n in names}
    header.write_text(header.read_text() + "\n// edited\n")
    assert {n for n in names if build.library_path(n) != before[n]} == \
        {"flash_attention", "paged_attention", "dual_branch", "fused_ln_add"}


def test_build_keeps_the_ptxas_report_beside_the_library(tmp_path,
                                                         monkeypatch):
    """A cached library is loaded with the ptxas report of the build that
    made it; a library whose report is missing is built again."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "print('ptxas info    : Used 40 registers, 0 bytes spill stores')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "PTXAS_LOG", {})
    lib = build.build_all(["page_copy"])["page_copy"]
    report = build.report_path(lib)
    assert lib.read_text() == "lib" and report.parent == lib.parent
    assert "Used 40 registers" in report.read_text()
    assert build.PTXAS_LOG["page_copy"] == report.read_text()
    build.PTXAS_LOG.clear()
    assert build.build_all(["page_copy"])["page_copy"] == lib
    assert calls.read_text() == "x"                 # loaded, not rebuilt
    assert build.PTXAS_LOG["page_copy"] == report.read_text()
    report.unlink()
    build.build_all(["page_copy"])
    assert calls.read_text() == "xx" and report.exists()


def test_port_imports_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro(\.| import))", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [f.name for f in examples] == [
        "torch_quickstart.py", "torch_serve_requests.py",
        "torch_train_fal_vs_baseline.py"]
    files += examples
    assert len(files) > 15
    port = ROOT / "src" / "repro_torch"
    for f in ("serve/decode.py", "obs/runmeta.py", "optim/grad_compress.py"):
        assert port / f in files, f
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
