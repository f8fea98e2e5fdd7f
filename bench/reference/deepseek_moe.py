"""Plain PerMFL tier rounds of DeepSeekMoE (arXiv:2401.06066): a dense
pre-norm decoder layer (RMSNorm, multi-head causal attention with rotary
positions, RMSNorm, a SwiGLU MLP), then fine-grained MoE layers whose FFN
is two always-on shared experts (one SwiGLU of their summed width) plus
routed experts: softmax gates over all experts from a float32 router,
each token's top k, the gates not renormalised (``norm_topk_prob``
false), an expert-level balance loss; then a final RMSNorm, an untied
head and mean next-token cross-entropy. Written from the paper and the
configuration file alone, with no code of the measured program; the
attention block and the helpers are ``reference/phi3.py``'s.

Departures from the paper, as the configuration file's ``assumed``
lists them: experts have a capacity, positions counted in groups of
``group_size`` tokens, each expert kept to int(group x k / E x factor)
(at least k) of its (token, choice) pairs a group, earlier tokens and,
within a token, its higher gates first; a pair over capacity is dropped
(its gate weighs nothing, the token keeps the shared experts' output).
The balance loss is over the batch's tokens (the published code's is per
sequence): E x sum_e frac_e x mean_prob_e, frac_e the share of the
batch's (token, choice) pairs, before capacity, that chose e, weighted
by ``aux_weight``. Routed experts run as a loop over experts that
gathers each expert's kept tokens and adds its gated output back.

Products and norms compute in float32 (TF32 off) and the parameters stay
in their stored type (bfloat16; the router float32), the prox step and
the team and server updates as in ``reference/phi3.py``. Forward and
backward run layer by layer (each layer's input kept, the layer
recomputed under autograd for its backward), so the reference fits
beside its three parameter trees at published widths. ``quant="fp8"``
rounds every product's operands to float8 (e4m3, one scale a tensor):
the control, a precision below bfloat16.

Parameters use the tree the harness hands the program: ``embed`` (V,
d); the lead's ``blocks/lead/{norm1,norm2}/scale`` (L0, d),
``attn/{wq,wk,wv,wo}``, ``mlp/{w_gate,w_up}`` (L0, d, f), ``w_down``
(L0, f, d); the MoE layers' ``blocks/pos0/{norm1,norm2}/scale`` (L1, d),
``attn/*``, ``moe/router`` (L1, d, E) float32, ``moe/experts/{w_gate,
w_up}`` (L1, E, d, fe), ``w_down`` (L1, E, fe, d), ``moe/shared/{w_gate,
w_up}`` (L1, d, fe x shared), ``w_down``; ``final_norm/scale`` (d,),
``lm_head`` (d, V).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.phi3 import _mm, _prox, _rms, _rope, nest

__all__ = ["init_leaf", "init_params", "leaf_shapes", "loss_and_grads",
           "nest", "tier_round"]

LEAD, MOE = "blocks/lead/", "blocks/pos0/"
ATTN = ("norm1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
        "norm2/scale")
DENSE = ATTN + ("mlp/w_gate", "mlp/w_up", "mlp/w_down")
SPARSE = ATTN + ("moe/router", "moe/experts/w_gate", "moe/experts/w_up",
                 "moe/experts/w_down", "moe/shared/w_gate",
                 "moe/shared/w_up", "moe/shared/w_down")


def leaf_shapes(m: dict) -> dict:
    """{leaf path: shape} of the model ``m`` describes."""
    n0 = m["first_dense_layers"]
    n1 = m["num_layers"] - n0
    d, f, v = m["d_model"], m["d_ff"], m["vocab_size"]
    hq = m["num_heads"] * m["head_dim"]
    hkv = m["num_kv_heads"] * m["head_dim"]
    mo = m["moe"]
    e, fe = mo["num_experts"], mo["expert_d_ff"]
    fs = fe * mo["num_shared_experts"]

    def attn(pre, n):
        return {f"{pre}norm1/scale": (n, d), f"{pre}attn/wq": (n, d, hq),
                f"{pre}attn/wk": (n, d, hkv), f"{pre}attn/wv": (n, d, hkv),
                f"{pre}attn/wo": (n, hq, d), f"{pre}norm2/scale": (n, d)}

    return {"embed": (v, d), **attn(LEAD, n0),
            f"{LEAD}mlp/w_gate": (n0, d, f), f"{LEAD}mlp/w_up": (n0, d, f),
            f"{LEAD}mlp/w_down": (n0, f, d), **attn(MOE, n1),
            f"{MOE}moe/router": (n1, d, e),
            f"{MOE}moe/experts/w_gate": (n1, e, d, fe),
            f"{MOE}moe/experts/w_up": (n1, e, d, fe),
            f"{MOE}moe/experts/w_down": (n1, e, fe, d),
            f"{MOE}moe/shared/w_gate": (n1, d, fs),
            f"{MOE}moe/shared/w_up": (n1, d, fs),
            f"{MOE}moe/shared/w_down": (n1, fs, d),
            "final_norm/scale": (d,), "lm_head": (d, v)}


def init_leaf(m: dict, seed: int, name: str, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    """One leaf of the initial weights, drawn on ``device`` by a generator
    of its own (seeded from ``seed`` and the leaf's place), so that any
    leaf can be drawn again alone: norm scales 1, the embedding normal
    x 0.02, every product weight normal / sqrt(fan in); the router in
    float32, every other leaf in ``dtype``."""
    shapes = leaf_shapes(m)
    shape = shapes[name]
    if name.endswith("router"):
        dtype = torch.float32
    if name.endswith("scale"):
        return torch.ones(shape, dtype=dtype, device=device)
    i = list(shapes).index(name)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 131 + i) % (1 << 63))
    out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return out.mul_(0.02 if name == "embed" else shape[-2] ** -0.5)


def init_params(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every leaf of :func:`init_leaf`, as a flat {path: tensor}."""
    return {k: init_leaf(m, seed, k, device, dtype) for k in leaf_shapes(m)}


def _attention(p, x, m, quant):
    """x plus causal multi-head attention of its RMSNorm."""
    b, s, _ = x.shape
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
    return x + _mm(o, p["attn/wo"], quant)


def _swiglu(h, w_gate, w_up, w_down, quant):
    return _mm(F.silu(_mm(h, w_gate, quant)) * _mm(h, w_up, quant), w_down,
               quant)


def _experts(p, h, m, quant, routes=None):
    """The MoE FFN of the (T, d) normed tokens h: (y (T, d), the weighted
    balance loss). ``routes``: a list that gets (the chosen ids (T, k),
    the pairs dropped)."""
    mo = m["moe"]
    e, k = mo["num_experts"], mo["top_k"]
    t = h.shape[0]
    gs = min(mo["group_size"], t)
    if t % gs:
        raise ValueError(f"{t} tokens in groups of {gs}")
    cap = max(int(gs * k / e * mo["capacity_factor"]), k)
    probs = _mm(h, p["moe/router"], quant).softmax(-1)           # (T, E)
    gates, idx = probs.topk(k, dim=-1)              # the higher gates first
    if mo["renormalize"]:
        gates = gates / gates.sum(-1, keepdim=True)
    chosen = torch.zeros(e, device=h.device).index_add_(
        0, idx.reshape(-1), torch.ones(t * k, device=h.device))
    aux = mo["aux_weight"] * e * torch.sum(chosen / (t * k)
                                           * probs.mean(0))
    y = _swiglu(h, p["moe/shared/w_gate"], p["moe/shared/w_up"],
                p["moe/shared/w_down"], quant)
    dropped = 0
    for ex in range(e):
        # this expert's (token, choice) pairs, by token, then by choice
        tok, ch = (idx == ex).nonzero(as_tuple=True)
        group = tok // gs
        rank = torch.arange(len(tok), device=h.device) \
            - torch.searchsorted(group, group)         # place in its group
        kept = rank < cap
        if routes is not None:
            dropped += int((~kept).sum())
        tok, ch = tok[kept], ch[kept]
        if not len(tok):
            continue
        out = _swiglu(h[tok], p["moe/experts/w_gate"][ex],
                      p["moe/experts/w_up"][ex], p["moe/experts/w_down"][ex],
                      quant)
        y = y.index_add(0, tok, out * gates[tok, ch][:, None])
    if routes is not None:
        routes.append((idx.to(torch.int32), dropped))
    return y, aux


def _layer(pre, p, x, m, quant, routes=None):
    """One layer of x (b, s, d): (its output, its weighted balance loss,
    0 for the dense lead)."""
    x = _attention(p, x, m, quant)
    h = _rms(x, p["norm2/scale"], m["norm_eps"])
    if pre == LEAD:
        return x + _swiglu(h, p["mlp/w_gate"], p["mlp/w_up"],
                           p["mlp/w_down"], quant), 0.0
    y, aux = _experts(p, h.reshape(-1, h.shape[-1]), m, quant, routes)
    return x + y.reshape(x.shape), aux


def _layers(m: dict) -> list:
    """(prefix, index, leaves) of every layer in order."""
    n0 = m["first_dense_layers"]
    return [(LEAD, i, DENSE) for i in range(n0)] \
        + [(MOE, i, SPARSE) for i in range(m["num_layers"] - n0)]


def loss_and_grads(params: dict, m: dict, tokens, targets, on_layer,
                   quant=None, routes=None):
    """(mean next-token cross-entropy plus the balance losses, the float32
    gradients of the embedding, the final norm and the head) of
    ``params`` (flat, any type) on (b, s) ``tokens`` / ``targets``. Each
    layer's gradients are handed, last layer first, to
    ``on_layer(prefix, i, {path: grad})``; ``routes`` gets each MoE
    layer's (ids, pairs dropped) of the forward."""
    f32 = lambda t: t.to(torch.float32, copy=True).requires_grad_(True)  # noqa: E731,E501
    layers = _layers(m)
    x = params["embed"].float()[tokens]
    xs, aux = [x], 0.0
    with torch.no_grad():
        for pre, i, names in layers:
            p = {k: params[pre + k][i].float() for k in names}
            x, a = _layer(pre, p, x, m, quant, routes)
            aux = aux + a
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
    for j in reversed(range(len(layers))):
        pre, i, names = layers[j]
        xi = xs[j].requires_grad_(True)
        p = {k: f32(params[pre + k][i]) for k in names}
        with torch.enable_grad():
            y, a = _layer(pre, p, xi, m, quant)
            outs, douts = [y], [dx]
            if torch.is_tensor(a):
                outs.append(a)
                douts.append(torch.ones_like(a))
            g = torch.autograd.grad(outs, [xi] + [p[k] for k in names],
                                    douts)
        dx = g[0]
        on_layer(pre, i, {pre + k: gk for k, gk in zip(names, g[1:])})
        xs[j + 1] = None
    demb = torch.zeros(params["embed"].shape, device=dx.device)
    demb.index_add_(0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    grads["embed"] = demb
    return (loss + aux).detach(), grads


def tier_round(theta: dict, w: dict, x: dict, m: dict, tokens, targets,
               hp: dict, quant=None, grad_norms=None, routes=None):
    """One tier round (``l_local`` prox-SGD steps of theta toward w, then
    eqs. 9 and 13), each tree flat {path: tensor}; new trees are returned
    and the given ones left as they are. ``grad_norms``: a dict filled
    with each leaf's gradient norm of the first local step; ``routes``:
    a list filled with the first local step's routing (each MoE layer's
    ids and pairs dropped). Returns (theta', w', x', mean loss of the
    local steps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a, lam = hp["alpha"], hp["lam"]
    eta, gamma, beta = hp["eta"], hp["gamma"], hp["beta"]
    losses = []
    for step in range(hp["l_local"]):
        new = dict(theta)
        sq, fresh = {}, set()

        def on_layer(pre, i, layer):
            for k, g in layer.items():
                if step == 0:
                    sq[k] = sq.get(k, 0.0) + float(g.double().square().sum())
                if k not in fresh:
                    new[k] = theta[k].clone()
                    fresh.add(k)
                new[k][i] = _prox(theta[k][i], g, w[k][i], a, lam)

        loss, grads = loss_and_grads(theta, m, tokens, targets, on_layer,
                                     quant, routes if step == 0 else None)
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
