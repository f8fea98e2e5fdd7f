"""Plain PerMFL tier rounds of a dense decoder (Phi-3-mini,
arXiv:2404.14219): a pre-norm stack of RMSNorm, multi-head causal
attention with rotary positions (half-split rotation), RMSNorm and a
SwiGLU MLP, a final RMSNorm and an untied head, mean next-token
cross-entropy. Written from the paper and the configuration file alone,
with no code of the measured program.

Products and norms compute in float32 (TF32 off) and the parameters
stay in their stored type (bfloat16): the prox step (eq. 4) rounds
once a step, and the team and server updates (eqs. 9 and 13) are
evaluated in the stored type, as a plain bfloat16 implementation of
them is. Forward and backward run layer by layer (each layer's input
kept, the layer recomputed under autograd for its backward), so the
reference fits beside its three parameter trees at published widths.
``quant="fp8"`` rounds every product's operands to float8 (e4m3, one
scale a tensor): the control, a precision below bfloat16.

Parameters use the tree the harness hands the program: ``embed`` (V,
d), ``blocks/pos0/{norm1,norm2}/scale`` (L, d), ``blocks/pos0/attn/
{wq,wk,wv,wo}`` (L, d, d), ``blocks/pos0/mlp/{w_gate,w_up}`` (L, d, f),
``w_down`` (L, f, d), ``final_norm/scale`` (d,), ``lm_head`` (d, V).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F8_MAX = 448.0


def leaf_shapes(m: dict) -> dict:
    """{leaf path: shape} of the decoder ``m`` describes."""
    L, d, f, v = m["num_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    hq = m["num_heads"] * m["head_dim"]
    hkv = m["num_kv_heads"] * m["head_dim"]
    return {"embed": (v, d),
            "blocks/pos0/norm1/scale": (L, d),
            "blocks/pos0/attn/wq": (L, d, hq),
            "blocks/pos0/attn/wk": (L, d, hkv),
            "blocks/pos0/attn/wv": (L, d, hkv),
            "blocks/pos0/attn/wo": (L, hq, d),
            "blocks/pos0/norm2/scale": (L, d),
            "blocks/pos0/mlp/w_gate": (L, d, f),
            "blocks/pos0/mlp/w_up": (L, d, f),
            "blocks/pos0/mlp/w_down": (L, f, d),
            "final_norm/scale": (d,),
            "lm_head": (d, v)}


def init_leaf(m: dict, seed: int, name: str, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    """One leaf of the initial weights, drawn on ``device`` by a generator
    of its own (seeded from ``seed`` and the leaf's place), so that any
    leaf can be drawn again alone: norm scales 1, the embedding normal
    x 0.02, every product weight normal / sqrt(fan in)."""
    shape = leaf_shapes(m)[name]
    if name.endswith("scale"):
        return torch.ones(shape, dtype=dtype, device=device)
    i = list(leaf_shapes(m)).index(name)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 131 + i) % (1 << 63))
    out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return out.mul_(0.02 if name == "embed" else shape[-2] ** -0.5)


def init_params(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every leaf of :func:`init_leaf`, as a flat {path: tensor}."""
    return {k: init_leaf(m, seed, k, device, dtype) for k in leaf_shapes(m)}


def nest(flat: dict) -> dict:
    """{"a/b": t} -> {"a": {"b": t}}."""
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _fq(t, quant):
    """``t`` rounded to float8 (e4m3, one scale for the tensor) and back,
    the gradient passed straight through; ``t`` itself without
    ``quant``."""
    if quant is None:
        return t
    s = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach()


def _mm(a, b, quant):
    return _fq(a, quant) @ _fq(b, quant)


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """Rotary positions 0..s-1 on x (b, s, h, hd), the two halves of each
    head rotated as pairs."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(p, x, m, quant):
    b, s, d = x.shape
    hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = _rms(x, p["norm1/scale"], m["norm_eps"])
    q = _rope(_mm(h, p["attn/wq"], quant).reshape(b, s, hq, hd),
              m["rope_theta"]).transpose(1, 2)
    k = _rope(_mm(h, p["attn/wk"], quant).reshape(b, s, hkv, hd),
              m["rope_theta"]).transpose(1, 2)
    v = _mm(h, p["attn/wv"], quant).reshape(b, s, hkv, hd).transpose(1, 2)
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    att = _mm(q, k.transpose(-1, -2), quant) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    att = att.masked_fill(mask, float("-inf")).softmax(-1)
    o = _mm(att, v, quant).transpose(1, 2).reshape(b, s, hq * hd)
    x = x + _mm(o, p["attn/wo"], quant)
    h = _rms(x, p["norm2/scale"], m["norm_eps"])
    g = F.silu(_mm(h, p["mlp/w_gate"], quant)) * _mm(h, p["mlp/w_up"], quant)
    return x + _mm(g, p["mlp/w_down"], quant)


LAYER = ("norm1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
         "norm2/scale", "mlp/w_gate", "mlp/w_up", "mlp/w_down")


def loss_and_grads(params: dict, m: dict, tokens, targets, on_layer,
                   quant=None):
    """(mean next-token cross-entropy, the float32 gradients of the
    embedding, the final norm and the head) of ``params`` (flat, any
    type) on (b, s) ``tokens`` / ``targets``. Each block's gradients are
    handed, last block first, to ``on_layer(i, {path: grad})``."""
    L = m["num_layers"]
    blk = "blocks/pos0/"
    f32 = lambda t: t.float().requires_grad_(True)  # noqa: E731
    x = params["embed"].float()[tokens]
    xs = [x]
    with torch.no_grad():
        for i in range(L):
            p = {k: params[blk + k][i].float() for k in LAYER}
            x = _layer(p, x, m, quant)
            xs.append(x)
    top = xs[-1].requires_grad_(True)
    fn, head = f32(params["final_norm/scale"]), f32(params["lm_head"])
    with torch.enable_grad():
        logits = _mm(_rms(top, fn, m["norm_eps"]), head, quant)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        dtop, dfn, dhead = torch.autograd.grad(loss, [top, fn, head])
    del logits
    grads = {"final_norm/scale": dfn, "lm_head": dhead}
    dx = dtop
    for i in reversed(range(L)):
        xi = xs[i].requires_grad_(True)
        p = {k: f32(params[blk + k][i]) for k in LAYER}
        with torch.enable_grad():
            y = _layer(p, xi, m, quant)
            g = torch.autograd.grad(y, [xi] + [p[k] for k in LAYER], dx)
        dx = g[0]
        on_layer(i, {blk + k: gk for k, gk in zip(LAYER, g[1:])})
        xs[i + 1] = None
    demb = torch.zeros(params["embed"].shape, device=dx.device)
    demb.index_add_(0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    grads["embed"] = demb
    return loss.detach(), grads


def _prox(theta, g, w, alpha, lam):
    """Eq. 4 in float32 from the stored values, rounded once."""
    t = theta.float()
    return (t - alpha * (g + lam * (t - w.float()))).to(theta.dtype)


def tier_round(theta: dict, w: dict, x: dict, m: dict, tokens, targets,
               hp: dict, quant=None, grad_norms=None):
    """One tier round (``l_local`` prox-SGD steps of theta toward w, then
    eqs. 9 and 13), each tree flat {path: tensor}; new trees are returned
    and the given ones left as they are. ``grad_norms``: a dict filled
    with each leaf's gradient norm of the first local step. Returns
    (theta', w', x', mean loss of the local steps)."""
    blk = "blocks/pos0/"
    a, lam = hp["alpha"], hp["lam"]
    eta, gamma, beta = hp["eta"], hp["gamma"], hp["beta"]
    losses = []
    for step in range(hp["l_local"]):
        new = dict(theta)
        sq = {}

        def on_layer(i, layer):
            for k, g in layer.items():
                if step == 0:
                    sq[k] = sq.get(k, 0.0) + float(g.double().square().sum())
                if i == m["num_layers"] - 1:
                    new[k] = theta[k].clone()
                new[k][i] = _prox(theta[k][i], g, w[k][i], a, lam)

        loss, grads = loss_and_grads(theta, m, tokens, targets, on_layer,
                                     quant)
        for k, g in grads.items():
            if step == 0:
                sq[k] = float(g.double().square().sum())
            new[k] = _prox(theta[k], g, w[k], a, lam)
        del grads
        if step == 0 and grad_norms is not None:
            grad_norms.update({k: v ** 0.5 for k, v in sq.items()})
        theta = new
        losses.append(float(loss))
    c = 1.0 - eta * lam - eta * gamma
    w = {k: c * v + eta * gamma * x[k] + lam * eta * theta[k]
         for k, v in w.items()}
    x = {k: (1 - beta * gamma) * v + beta * gamma * w[k]
         for k, v in x.items()}
    return theta, w, x, sum(losses) / len(losses)
