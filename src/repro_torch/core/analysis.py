"""The paper's §3 motivation analyses: CKA similarity across blocks (Fig
3a), the gradient magnitude of each block's MHA output (Fig 4a) and the
perplexity with attention layers or MHA -> MLP connections removed (Figs
3b / 4b).

Port of ``repro/core/analysis.py``.  They run on the dense decoder with
the layer stack unrolled (block 0, then ``params["blocks"]`` in depth
order) so that each block's activations can be captured and perturbed.
Each block is ``x + a + y`` with no post-norms, as in the reference.  The
attention goes through ``ops.flash_attention`` (``attention.gqa_apply``):
on the card the analyses launch the flash kernel's forward and, for the
gradient magnitudes, its backward; on the CPU they run its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core import fal
from repro_torch.models import attention as A
from repro_torch.models import blocks as BL
from repro_torch.models import layers as L
from repro_torch.models import model as M


def linear_cka(x, y):
    """Linear CKA between feature matrices (n, d1), (n, d2) [Kornblith'19]."""
    x = x - x.mean(0, keepdim=True)
    y = y - y.mean(0, keepdim=True)
    xty = x.T @ y
    num = (xty * xty).sum()
    den = torch.sqrt(((x.T @ x) ** 2).sum()) * torch.sqrt(
        ((y.T @ y) ** 2).sum())
    return num / torch.clamp(den, min=1e-12)


def _iter_layer_params(params, cfg):
    """Yield (block params, window, depth index) in depth order."""
    wsched = BL.window_schedule(cfg)
    yield params["block0"], wsched[0], 0
    for i, pb in enumerate(params["blocks"], start=1):
        yield pb, wsched[i], i


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def _unrolled(params, cfg, batch, visit):
    """The unrolled dense forward -> final hidden states (B, S, D), each
    block ``x + a + y``.  ``visit`` (a ``_Visit``) may replace each block's
    MHA output before anything reads it (``attention``) and its MLP input
    (``mlp_input``), and sees each block's tensors (``block``)."""
    tokens = batch["tokens"]
    positions = _positions(tokens)
    x = M._embed_tokens(params, cfg, tokens, positions,
                        batch.get("image_embeds"))
    a1_sig = None
    for pb, window, idx in _iter_layer_params(params, cfg):
        h = L.norm_apply(pb["ln1"], x, cfg.norm)
        a = visit.attention(idx, A.gqa_apply(pb["attn"], cfg, h, positions,
                                             window=window))
        if idx == 0:
            mlp_in = fal.block0_mlp_input(cfg, pb, x, a)
            a1_sig = fal.first_attention_signal(cfg, pb, a)
        else:
            mlp_in = fal.mlp_input(cfg, pb, x, a, a1_sig)
        mlp_in = visit.mlp_input(pb, x, mlp_in)
        y = L.mlp_apply(pb["ffn"], mlp_in, cfg.mlp)
        visit.block(a, mlp_in, y, x)
        x = x + a + y
    return x


class _Visit:
    """No change to the forward and nothing recorded."""

    def attention(self, idx, a):
        return a

    def mlp_input(self, pb, x, mlp_in):
        return mlp_in

    def block(self, a, mlp_in, y, x):
        pass


def collect_block_activations(params, cfg, batch):
    """Unrolled forward capturing each block's (mha_out, mlp_in, mlp_out,
    x): a dict of lists (n_layers) of (B, S, D) tensors, and "final", the
    last block's output.  Dense decoder families only."""
    rec = {"mha_out": [], "mlp_in": [], "mlp_out": [], "x": []}

    class Record(_Visit):
        def block(self, a, mlp_in, y, x):
            rec["mha_out"].append(a)
            rec["mlp_in"].append(mlp_in)
            rec["mlp_out"].append(y)
            rec["x"].append(x)

    with torch.no_grad():
        rec["final"] = _unrolled(params, cfg, batch, Record())
    return rec


def cka_table(params, cfg, batch):
    """Paper Fig 3(a): CKA similarity of consecutive blocks' MHA outputs,
    MLP inputs and MLP outputs."""
    rec = collect_block_activations(params, cfg, batch)
    out = {"mha_out": [], "mlp_in": [], "mlp_out": []}
    for k in out:
        seq = rec[k]
        for i in range(len(seq) - 1):
            a = seq[i].reshape(-1, seq[i].shape[-1]).float()
            b = seq[i + 1].reshape(-1, seq[i + 1].shape[-1]).float()
            out[k].append(float(linear_cka(a, b)))
    return out


def _loss(params, cfg, batch, x):
    logits = M._logits(params, cfg, x)
    tokens = batch["tokens"]
    return M.cross_entropy(logits[:, :-1], tokens[:, 1:])


def mha_gradient_magnitudes(params, cfg, batch):
    """Paper Fig 4(a): the L1 norm of dLoss / d(MHA_i output) per block,
    from zero perturbations eps_i added to every block's MHA output and
    differentiated with ``torch.autograd.grad`` (the reference's
    ``jax.grad`` over them)."""
    B, S = batch["tokens"].shape
    n = len(params["blocks"]) + 1
    eps = [torch.zeros((B, S, cfg.d_model), device=batch["tokens"].device,
                       requires_grad=True) for _ in range(n)]

    class Perturb(_Visit):
        def attention(self, idx, a):
            return a + eps[idx]

    with torch.enable_grad():
        loss = _loss(params, cfg, batch,
                     _unrolled(params, cfg, batch, Perturb()))
        grads = torch.autograd.grad(loss, eps)
    return [float(g.abs().sum()) for g in grads]


def ablate_attention_perplexity(params, cfg, batch, drop_layer=None,
                                drop_connections=False, drop_all_mha=False):
    """Paper Fig 3(b) / 4(b): perplexity (``exp`` of the shifted cross
    entropy) with block ``drop_layer``'s MHA output zeroed, every MHA output
    zeroed (``drop_all_mha``), or, under preln only, the direct MHA -> MLP
    connection removed (``drop_connections``: each MLP sees ln2(x))."""
    class Ablate(_Visit):
        def attention(self, idx, a):
            if drop_all_mha or (drop_layer is not None and idx == drop_layer):
                return torch.zeros_like(a)
            return a

        def mlp_input(self, pb, x, mlp_in):
            if drop_connections and cfg.connection == "preln":
                return L.norm_apply(pb["ln2"], x, cfg.norm)
            return mlp_in

    with torch.no_grad():
        ce = _loss(params, cfg, batch, _unrolled(params, cfg, batch,
                                                 Ablate()))
    return float(torch.exp(ce))
