"""The collective structure of the port's explicit tensor parallelism, on
the CPU (two ranks over gloo, ``core.tp.run_ranks``, a ``file://``
rendezvous under ``tmp_path``, one intra-op thread a rank; the reduced
llama3.2-3b at 4 layers, fp32): the counters of ``core.tp`` hold the
numbers the reference's passing structural tests state on lowered HLO
(``tests/test_distributed.py:35-104``), here for the forward and the
backward; the sequence-parallel layout gives the replicated logits; one
steady-state block's padded decode tick pays one all-reduce sequentially
and under the dual-branch dispatch (``tests/test_distributed.py``'s gate,
ported as ``tp.assert_dual_no_extra_collectives``) and matches the port's
one-device tick; and the launcher trains under two spawned ranks and
refuses what is not ported.

Counts at L = 4 (block 0 unscanned, plus L - 1 times the reference's scan
body): forward all-reduces preln 8, fal 5, parallel 4, falplus 8,
ablation1 8, ablation2 5.  Bytes are each collective's output on a rank.
"""
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402

import torch_tp_ranks as R  # noqa: E402

L = 4
FORWARD_ALL_REDUCES = {"preln": 8, "fal": 5, "parallel": 4, "falplus": 8,
                       "ablation1": 8, "ablation2": 5}
#: all-reduces the recompute adds under remat: torch.utils.checkpoint stops
#: recomputing once the last tensor the backward needs is back, so a
#: block's closing all-reduce (fused: its only one) is not repeated; the
#: assembled attention before an LN is (fal: block 0's only)
REMAT_ADDS = {"fal": 1, "preln": L}
TP = 2
TOL = 1e-5          # fp32; partial sums added in another order


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    res = tp.run_ranks(
        "torch_tp_ranks:structure", TP, backend="gloo", threads=1,
        workdir=str(tmp_path_factory.mktemp("tp_structure")),
        args=(tuple(REMAT_ADDS),))
    return {"structure": res, "decode": [r["decode"] for r in res]}


def _counts(runs, mode, sp=False, remat=False, which="train"):
    return [r[(mode, sp, remat)][which] for r in runs["structure"]]


@pytest.mark.parametrize("mode", R.MODES)
def test_forward_allreduce_counts(runs, mode):
    for c in _counts(runs, mode, which="forward"):
        assert tp.count(c, "all-reduce") == FORWARD_ALL_REDUCES[mode], c
        assert set(c) == {"all-reduce"}, c


@pytest.mark.parametrize("mode", R.MODES)
def test_backward_counts_equal_forward(runs, mode):
    """One *f* a block entry (and one on FAL's signal): the backward pays
    as many all-reduces, of the same bytes, as the forward; the train
    step's sum of the replicated leaves' partial gradients is one more
    (direction ``step``) where the mode has such leaves."""
    for c in _counts(runs, mode):
        n = FORWARD_ALL_REDUCES[mode]
        for d in ("forward", "backward"):
            assert tp.count(c, "all-reduce", d) == n, c
        assert tp.count(c, "all-reduce", "backward", "bytes") == \
            tp.count(c, "all-reduce", "forward", "bytes")
        fused_somewhere = mode in ("fal", "parallel", "ablation2")
        assert tp.count(c, "all-reduce", "step") == int(fused_somewhere)


def test_fal_halves_preln_bytes(runs):
    """(L + 1) / (2 L) of preln's all-reduce bytes, forward and backward."""
    for fal, pre in zip(_counts(runs, "fal"), _counts(runs, "preln")):
        for d in ("forward", "backward"):
            b_fal = tp.count(fal, "all-reduce", d, "bytes")
            b_pre = tp.count(pre, "all-reduce", d, "bytes")
            assert b_fal * 2 * L == b_pre * (L + 1), (b_fal, b_pre)


@pytest.mark.parametrize("mode", sorted(REMAT_ADDS))
def test_remat_adds_only_recompute_forward(runs, mode):
    for plain, remat in zip(_counts(runs, mode),
                            _counts(runs, mode, remat=True)):
        assert tp.count(remat, "all-reduce", "backward") == \
            tp.count(plain, "all-reduce", "backward")
        assert tp.count(remat, "all-reduce", "forward") == \
            tp.count(plain, "all-reduce", "forward") + REMAT_ADDS[mode]
    for a, b in zip(_counts(runs, mode, which="logits"),
                    _counts(runs, mode, remat=True, which="logits")):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("mode", R.MODES)
def test_sp_reduce_scatter_structure(runs, mode):
    """Each replicated all-reduce becomes one reduce-scatter at 1/tp the
    bytes (block 0 under fal / falplus keeps its one true all-reduce, the
    signal export); an all-gather of the LN region precedes each
    reduce-scatter; the logits equal the replicated TP path's."""
    for repl, sp in zip(_counts(runs, mode, which="forward"),
                        _counts(runs, mode, sp=True, which="forward")):
        ar_n, ar_b = (tp.count(repl, "all-reduce", what=w)
                      for w in ("calls", "bytes"))
        sp_ar_n, sp_ar_b = (tp.count(sp, "all-reduce", what=w)
                            for w in ("calls", "bytes"))
        sp_rs_n, sp_rs_b = (tp.count(sp, "reduce-scatter", what=w)
                            for w in ("calls", "bytes"))
        assert sp_ar_n + sp_rs_n == ar_n, sp
        assert sp_ar_b + TP * sp_rs_b == ar_b, sp
        assert sp_ar_n == (1 if mode in ("fal", "falplus") else 0), sp
        assert tp.count(sp, "all-gather") >= sp_rs_n - 1, sp
    for a, b in zip(_counts(runs, mode, which="logits"),
                    _counts(runs, mode, sp=True, which="logits")):
        torch.testing.assert_close(b, a, atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", ["preln", "fal"])
def test_tp_forward_matches_replicated(runs, mode):
    """``tp.make_tp_forward``'s stack over two ranks (replicated and SP)
    reproduces the same blocks run on one rank (reference
    ``tests/test_distributed.py:107-126``: 1e-4)."""
    for r in runs["structure"]:
        for sp in (False, True):
            assert r["tp_forward"][(mode, sp)] < 1e-4, (sp, r["tp_forward"])


@pytest.mark.parametrize("mode", ["fal", "parallel"])
def test_dual_decode_tick_one_allreduce(runs, mode):
    for r in runs["decode"]:
        gate = r["gate"][mode]
        assert tp.count(gate["sequential"], "all-reduce") == 1
        assert gate["dual"] == gate["sequential"]
        ticks = r[mode]
        assert ticks["dual"]["counts"] == ticks["sequential"]["counts"]
        assert tp.count(ticks["sequential"]["counts"], "all-reduce") == 1


@pytest.mark.parametrize("mode", ["fal", "parallel", "fal-kv1"])
def test_decode_ticks_match_one_device(runs, mode):
    """Sequential and dual TP ticks agree within 1e-5 and match the port's
    one-device tick on the same weights and cache; each rank wrote its KV
    heads of the new rows as the one-device tick did (``fal-kv1``: one KV
    head for two ranks, each computing it whole from the replicated wk /
    wv)."""
    for r in runs["decode"]:
        seq, dual = r[mode]["sequential"], r[mode]["dual"]
        torch.testing.assert_close(dual["out"], seq["out"], atol=TOL, rtol=0)
        for t in (seq, dual):
            torch.testing.assert_close(t["out"], t["one_device"], atol=TOL,
                                       rtol=0)
            assert t["cache_err"] == 0.0


def test_launcher_trains_under_two_ranks(tmp_path):
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama3.2-3b", "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--tp", "explicit", "--sp",
            "--backend", "gloo", "--init-method",
            f"file://{tmp_path}/store"]
    logs = tp.spawn(argv, TP, workdir=str(tmp_path / "ranks"), threads=1,
                    timeout=300)
    finals = [[ln for ln in log.splitlines() if ln.startswith("final loss")]
              for log in logs]
    assert finals[0] == finals[1] and len(finals[0]) == 1, logs
    assert "tp=explicit x2 sp=True" in logs[0]
    assert np.isfinite(float(finals[0][0].split()[-1]))


@pytest.mark.parametrize("argv,err,match", [
    (["--mesh", "single"], NotImplementedError, "pod layouts"),
    (["--tp", "gspmd"], NotImplementedError, "gspmd"),
    (["--tp", "explicit"], RuntimeError, "process group"),
    (["--sp"], ValueError, "--sp requires --tp explicit")])
def test_launcher_refusals(argv, err, match):
    args = ["--arch", "llama3.2-3b", "--reduced", "--steps", "1",
            "--device", "cpu"]
    with pytest.raises(err, match=match):
        TL.main(args + argv)


@pytest.mark.parametrize("kw,err,match", [
    (dict(tp="gspmd"), NotImplementedError, "no PyTorch counterpart"),
    (dict(grad_compress="int8"), NotImplementedError, "not ported"),
    (dict(grad_compress="lowrank"), NotImplementedError, "not ported"),
    (dict(grad_compress="zip"), ValueError, "unknown grad_compress"),
    (dict(data_group=object()), NotImplementedError, "data-parallel"),
    (dict(sp=True, phase="paged"), ValueError, "full-sequence layout")])
def test_plan_refusals(kw, err, match):
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(err, match=match):
        ExecutionPlan.from_group(object(), **kw).validate(cfg)


def test_nccl_refuses_more_ranks_than_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="one card per rank"):
        tp.init_tp_group("nccl", rank=0, world_size=n + 1,
                         init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="backend must be one of"):
        tp.init_tp_group("mpi", rank=0, world_size=1)
