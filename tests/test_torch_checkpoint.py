"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's (``repro.train.checkpoint``) on the CPU, at the reduced gemma2
config (d 128, 2 layers, window 64, fp32): a checkpoint written by either
package is restored by the other with equal leaves under the same keys.

The port keeps the blocks after block 0 as a list of per-block dicts, the
reference stacks them under ``blocks_dense``; AdamW's count is an int here
and a 0-d int32 there; bf16 leaves travel as raw ``|V2`` words.  Leaves
that cross are compared exactly (``np.array_equal``: the same fp32 bits);
one port step after restoring a reference checkpoint is held to the
one-step rules of ``test_torch_train.py`` (params within 2 lr, norm scales
within 1e-6, at most 0.1% of the weights more than 1e-7 apart)."""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import step as RT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import step as TT  # noqa: E402

ARCH = "gemma2-27b"
LR = 3e-4


def _tokens(cfg, seed, B=2, S=40):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced gemma2: config, initial params, its jitted
    train step and its state after two steps."""
    rcfg = ref_config(ARCH).reduced()
    params = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(4), rcfg)
    ocfg = RO.AdamWConfig(lr=LR)
    step = jax.jit(RT.make_train_step(rcfg, ocfg))
    state = {"params": params, "opt": RO.init_opt_state(params, ocfg)}
    for i in range(2):
        state, _ = step(state, {"tokens": jnp.asarray(_tokens(rcfg, i))})
    return rcfg, params, step, state


def _port_state(ref_params, tcfg, ocfg=None):
    params = interop.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                       tcfg, "cpu", dtype="float32")
    return TT.init_state(0, tcfg, ocfg or TO.AdamWConfig(lr=LR),
                         params=params)


def _port_stepped(ref, n=2):
    """The port's state after ``n`` steps from the reference's initial
    params (the reference's batches)."""
    rcfg, params, _, _ = ref
    tcfg = get_config(ARCH).reduced()
    state = _port_state(params, tcfg)
    step = TT.make_train_step(tcfg, TO.AdamWConfig(lr=LR))
    for i in range(n):
        state, _ = step(state, {"tokens": torch.from_numpy(_tokens(rcfg,
                                                                    i))})
    return tcfg, state


def _flat_ref(state):
    """The reference state's leaves under the checkpoint's keys."""
    return {k: np.asarray(v) for k, v in RC._flatten(
        jax.tree.map(np.asarray, state)).items()}


def test_port_save_restores_in_the_reference(ref, tmp_path):
    """The port's state after two steps, saved by the port and restored by
    the reference into its own (stacked) structure: every leaf equal to
    the port's, the count the int32 2."""
    _, _, _, r_state = ref
    _, t_state = _port_stepped(ref)
    TC.save(tmp_path, t_state, step=2, meta={"arch": ARCH})
    like = jax.tree.map(jnp.zeros_like, r_state)
    back = _flat_ref(RC.restore(str(tmp_path), like))
    ours = TC._flatten(t_state)
    assert back.keys() == ours.keys()
    for key, arr in ours.items():
        assert back[key].dtype == arr.dtype and \
            np.array_equal(back[key], arr), key
    assert int(back["opt/count"]) == 2


def test_reference_save_restores_in_the_port_and_trains_on(ref, tmp_path):
    """The reference's state after two steps, saved by the reference and
    restored by the port: the same leaves; then one port step matches one
    reference step from it under the one-step rules."""
    from test_torch_train import _close_step
    rcfg, _, r_step, r_state = ref
    RC.save(str(tmp_path), r_state, step=2, meta={"arch": ARCH})
    tcfg, like = _port_stepped(ref, n=0)
    t_state = TC.restore(tmp_path, like)
    assert t_state["opt"]["count"] == 2
    assert isinstance(t_state["opt"]["count"], int)
    want = _flat_ref(r_state)
    for key, arr in TC._flatten(t_state).items():
        assert np.array_equal(arr, want[key]), key
    assert all(p.requires_grad for _, p in TO.named_leaves(
        t_state["params"]))
    toks = _tokens(rcfg, 7)
    r_next, r_m = r_step(r_state, {"tokens": jnp.asarray(toks)})
    step = TT.make_train_step(tcfg, TO.AdamWConfig(lr=LR))
    t_next, t_m = step(t_state, {"tokens": torch.from_numpy(toks)})
    assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= 1e-5
    _close_step(r_next, t_next, tcfg, LR)
    assert t_next["opt"]["count"] == int(r_next["opt"]["count"]) == 3


def test_port_round_trip_is_bit_identical(ref, tmp_path):
    """save -> restore in the port: every tensor the same bits, in the same
    dtype, device and gradient flag, and the count the same int;
    ``latest_step`` reads the manifest's step and ``step=`` picks a file."""
    _, t_state = _port_stepped(ref)
    assert TC.latest_step(tmp_path) is None
    TC.save(tmp_path, t_state, step=5)
    TC.save(tmp_path, t_state, step=9)
    assert TC.latest_step(tmp_path) == 9
    for step in (None, 5):
        back = TC.restore(tmp_path, t_state, step=step)
        assert back["opt"]["count"] == t_state["opt"]["count"] == 2
        for tree in (("params",), ("opt", "m"), ("opt", "v")):
            a, b = t_state, back
            for k in tree:
                a, b = a[k], b[k]
            pairs = list(zip(TO.named_leaves(a), TO.named_leaves(b)))
            assert pairs
            for (pa, ta), (pb, tb) in pairs:
                assert pa == pb and tb.dtype == ta.dtype
                assert tb.requires_grad == ta.requires_grad
                assert torch.equal(tb.detach(), ta.detach()), (tree, pa)


def test_manifest_keys_equal_the_references(ref, tmp_path):
    """The manifest of the port's save and of the reference's save of the
    same model: the same step, meta and sorted keys, key for key, and the
    same shape under each key."""
    _, _, _, r_state = ref
    _, t_state = _port_stepped(ref)
    meta = {"arch": ARCH, "connection": "fal"}
    RC.save(str(tmp_path / "ref"), r_state, step=2, meta=meta)
    TC.save(tmp_path / "port", t_state, step=2, meta=meta)
    mr, mt = (json.loads((tmp_path / d / "manifest.json").read_text())
              for d in ("ref", "port"))
    assert mt == mr
    assert "params/blocks_dense/attn/wq" in mt["keys"]
    assert "opt/count" in mt["keys"]
    with np.load(tmp_path / "ref" / "ckpt_2.npz") as a, \
            np.load(tmp_path / "port" / "ckpt_2.npz") as b:
        for key in mr["keys"]:
            assert a[key].shape == b[key].shape, key
            assert a[key].dtype == b[key].dtype, key


def test_bf16_leaves_cross_as_raw_words(ref, tmp_path):
    """bf16 AdamW moments (the 671B config's ``state_dtype``): the
    reference's npz stores them as ``|V2``; the port restores those bits as
    torch.bfloat16, writes its own bf16 leaves the same raw way, and reads
    them back bit for bit."""
    rcfg, params, _, _ = ref
    r_ocfg = RO.AdamWConfig(lr=LR, state_dtype="bfloat16")
    r_step = jax.jit(RT.make_train_step(rcfg, r_ocfg))
    r_state, _ = r_step({"params": params,
                         "opt": RO.init_opt_state(params, r_ocfg)},
                        {"tokens": jnp.asarray(_tokens(rcfg, 0))})
    RC.save(str(tmp_path / "ref"), r_state, step=1)
    with np.load(tmp_path / "ref" / "ckpt_1.npz") as f:
        assert f["opt/m/blocks_dense/attn/wq"].dtype == np.dtype("V2")
    tcfg = get_config(ARCH).reduced()
    t_ocfg = TO.AdamWConfig(lr=LR, state_dtype="bfloat16")
    like = _port_state(params, tcfg, t_ocfg)
    assert like["opt"]["m"]["embed"]["emb"].dtype == torch.bfloat16
    back = TC.restore(tmp_path / "ref", like)
    want = RC._flatten(jax.tree.map(np.asarray, r_state))
    got = TC._flatten(back)
    for key in want:
        a, b = np.asarray(want[key]), got[key]
        assert a.dtype.itemsize == b.dtype.itemsize, key
        assert a.tobytes() == b.tobytes(), key
    TC.save(tmp_path / "port", back, step=1)
    with np.load(tmp_path / "port" / "ckpt_1.npz") as f:
        assert f["opt/v/embed/emb"].dtype == np.dtype("V2")
    again = TC.restore(tmp_path / "port", like)
    for (_, a), (_, b) in zip(TO.named_leaves(back["opt"]["m"]),
                              TO.named_leaves(again["opt"]["m"])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_launcher_ckpt_writes_a_checkpoint_both_packages_read(tmp_path,
                                                              capsys):
    """``launch.train --ckpt DIR``: manifest.json at step == steps, with
    the reference's meta; the port restores it into the trainer's state
    structure and the reference reads its keys."""
    ckpt = tmp_path / "ckpt"
    args = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt", str(ckpt)]
    state, hist = TL.main(args)
    capsys.readouterr()
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert manifest["step"] == 2 == TC.latest_step(ckpt)
    assert manifest["meta"] == {"arch": ARCH, "connection": "fal"}
    back = TC.restore(ckpt, state)
    assert back["opt"]["count"] == 2
    for (_, a), (_, b) in zip(TO.named_leaves(state["params"]),
                              TO.named_leaves(back["params"])):
        assert torch.equal(a.detach(), b.detach())
    rcfg = ref_config(ARCH).reduced()
    like = jax.eval_shape(lambda: {
        "params": RM.init_params(jax.random.PRNGKey(0), rcfg),
        "opt": RO.init_opt_state(
            RM.init_params(jax.random.PRNGKey(0), rcfg), RO.AdamWConfig())})
    like = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), like)
    r_back = RC.restore(str(ckpt), like)
    assert int(r_back["opt"]["count"]) == 2


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b",
                                  "whisper-small"])
def test_family_checkpoints_cross_both_ways(arch, tmp_path):
    """mamba's stacked ``blocks``, zamba's ``mamba`` (n_groups, attn_every,
    ...), ``mamba_tail``, ``in_proj`` and ``shared``, whisper's
    ``enc_blocks`` / ``dec_blocks``: the reference's state after one step,
    saved by the reference, restores in the port leaf for leaf; the
    port's save of the restored state restores in the reference with every
    leaf and key equal; one port step from it follows the reference's step
    (loss within 1e-5, params by the one-step rules) with a weight decay of
    0.5, so that the decay of the stacked leaves' norm scales (a list of
    lists in zamba's ``mamba``) shows."""
    kw = {"n_layers": 5} if arch.startswith("zamba") else {}
    rcfg = ref_config(arch).reduced().replace(**kw)
    tcfg = get_config(arch).reduced().replace(**kw)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, rcfg.vocab, (2, 32)).astype(np.int32)}
    if rcfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, rcfg.n_enc_frames, rcfg.d_model)).astype(np.float32)
    ocfg = RO.AdamWConfig(lr=LR, weight_decay=0.5)
    params = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(6), rcfg)
    r_step = jax.jit(RT.make_train_step(rcfg, ocfg))
    r_state = {"params": params, "opt": RO.init_opt_state(params, ocfg)}
    r_state, _ = r_step(r_state, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    RC.save(str(tmp_path / "ref"), r_state, step=1)
    like = _port_state(params, tcfg, TO.AdamWConfig(lr=LR,
                                                    weight_decay=0.5))
    t_state = TC.restore(tmp_path / "ref", like)
    want = _flat_ref(r_state)
    got = TC._flatten(t_state)
    assert got.keys() == want.keys()
    for key, arr in got.items():
        assert np.array_equal(arr, want[key]), key
    TC.save(tmp_path / "port", t_state, step=1)
    back = _flat_ref(RC.restore(str(tmp_path / "port"),
                                jax.tree.map(jnp.zeros_like, r_state)))
    for key, arr in want.items():
        assert back[key].dtype == arr.dtype and \
            np.array_equal(back[key], arr), key
    from test_torch_train import _close_step
    r_next, r_m = r_step(r_state, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    t_next, t_m = TT.make_train_step(
        tcfg, TO.AdamWConfig(lr=LR, weight_decay=0.5))(
        t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= 1e-5
    _close_step(r_next, t_next, tcfg, LR)
