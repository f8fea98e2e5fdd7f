"""Plain PerMFL (Algorithm 1 of arXiv:2407.14251) on the paper's CNN.

Written from the paper and the configuration file alone, with no code
of the measured program: float32 throughout, the convolutions as
``F.conv2d`` (the devices as groups), the dense layers as batched
products, full participation, and optionally every uplink compressed by
top-k with error feedback. It reads the same initial weights and data
the harness hands the program, and works the tiers out itself.

Parameters are flat dicts ``{"conv0.w": ..., ...}`` of the unstacked
model (convolution weights HWIO, dense weights (in, out)); a tier
carries leading axes: x (), w (M,), theta (M, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def leaf_shapes(model: dict) -> dict:
    """{leaf name: shape} of the CNN ``model`` describes, in the order
    the layers run."""
    h, w, c = model["input_shape"]
    out = {}
    for i, cout in enumerate(model["conv_channels"]):
        out[f"conv{i}.w"] = (3, 3, c, cout)
        out[f"conv{i}.b"] = (cout,)
        h, w, c = h // 2, w // 2, cout
    dims = [h * w * c] + list(model["hidden"]) + [model["num_classes"]]
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        out[f"dense{i}.w"] = (a, b)
        out[f"dense{i}.b"] = (b,)
    return out


def init_params(model: dict, seed: int, device) -> dict:
    """He-normal weights and zero biases, drawn on ``device`` from one
    generator seeded with ``seed``, in float32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in leaf_shapes(model).items():
        if name.endswith(".b"):
            out[name] = torch.zeros(shape, device=device)
            continue
        fan_in = shape[0] if len(shape) == 2 else 9 * shape[2]
        out[name] = torch.randn(shape, generator=gen, device=device) \
            * (2.0 / fan_in) ** 0.5
    return out


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """D models at once: leaves (D, ...), x (D, B, H, W, C) -> logits
    (D, B, classes)."""
    d, b, h, w, c = x.shape
    y = x.permute(1, 0, 4, 2, 3).reshape(b, d * c, h, w)
    i = 0
    while f"conv{i}.w" in params:
        k = params[f"conv{i}.w"]                       # (D, 3, 3, cin, cout)
        cin, cout = k.shape[-2:]
        k = k.permute(0, 4, 3, 1, 2).reshape(d * cout, cin, 3, 3)
        y = F.conv2d(y, k, params[f"conv{i}.b"].reshape(d * cout),
                     padding=1, groups=d)
        y = F.max_pool2d(torch.relu(y), 2)
        c = cout
        i += 1
    hh, ww = y.shape[-2:]
    y = y.reshape(b, d, c, hh, ww).permute(1, 0, 3, 4, 2).reshape(d, b, -1)
    j = 0
    while f"dense{j}.w" in params:
        y = torch.baddbmm(params[f"dense{j}.b"][:, None, :], y,
                          params[f"dense{j}.w"])
        if f"dense{j + 1}.w" in params:
            y = torch.relu(y)
        j += 1
    return y


def device_losses(params: dict, x, y) -> torch.Tensor:
    """Each model's mean cross-entropy on its own samples, (D,)."""
    logits = forward(params, x)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         y.reshape(-1).long(), reduction="none")
    return ce.reshape(y.shape).mean(-1)


def _flat2(tier: dict, lead: int) -> dict:
    """A tier's leaves with their ``lead`` leading axes merged into one."""
    return {k: v.reshape((-1,) + v.shape[lead:]) for k, v in tier.items()}


def grads(theta: dict, x, y):
    """(losses (D,), gradients {leaf: (D, ...)}) of every device's model
    on its own samples."""
    live = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    with torch.enable_grad():
        losses = device_losses(live, x, y)
        g = torch.autograd.grad(losses.sum(), list(live.values()))
    return losses.detach(), dict(zip(live, g))


def topk_ef(delta: torch.Tensor, ef: torch.Tensor, k_frac: float):
    """Top-k with error feedback over each sender's leaf (senders lead,
    the leaf flattened): the message is delta + ef, the k = round(k_frac
    p) values of largest magnitude cross, the rest stays as the new
    residual. Returns (what crosses, new residual)."""
    msg = (delta + ef).reshape(delta.shape[0], -1)
    p = msg.shape[1]
    k = max(1, min(p, round(k_frac * p)))
    idx = msg.abs().topk(k, dim=1).indices
    sent = torch.zeros_like(msg).scatter_(1, idx, msg.gather(1, idx))
    return sent.reshape(delta.shape), (msg - sent).reshape(delta.shape)


def wire_bytes(shapes: dict, k_frac) -> tuple:
    """(fp32 bytes, compressed bytes) of one model or delta: 4 bytes a
    value, or a top-k message's 4-byte value and 4-byte index for each
    of its k values a leaf (k_frac None: uncompressed)."""
    full, comp = 0, 0
    for shape in shapes.values():
        p = 1
        for s in shape:
            p *= s
        full += 4 * p
        comp += 8 * max(1, min(p, round(k_frac * p))) if k_frac else 4 * p
    return full, comp


def permfl_round(state: dict, train: dict, hp: dict, k_frac=None) -> dict:
    """One global round from ``state`` = {"x", "w", "theta"[, "ef_dev",
    "ef_team"]} (tiers as dicts of leaves): K team iterations of L
    prox-SGD device steps (eq. 4) and the team update (eq. 9), then the
    global update (eq. 13). ``k_frac``: every uplink (device -> team each
    team iteration, team -> server once) carries top-k with error
    feedback. Returns the new state."""
    x = state["x"]
    m, n = state["theta"][next(iter(x))].shape[:2]
    tx, ty = (train[k].reshape((m * n,) + train[k].shape[2:])
              for k in ("x", "y"))
    a, lam = hp["alpha"], hp["lam"]
    eta, gamma, beta = hp["eta"], hp["gamma"], hp["beta"]
    ef_dev, ef_team = state.get("ef_dev"), state.get("ef_team")
    w = {k: v.expand((m,) + v.shape).clone() for k, v in x.items()}
    theta = None
    for _ in range(hp["k_team"]):
        anchor = {k: v[:, None].expand((m, n) + v.shape[1:])
                  for k, v in w.items()}
        theta = {k: v.clone() for k, v in anchor.items()}
        for _ in range(hp["l_local"]):
            _, g = grads(_flat2(theta, 2), tx, ty)
            theta = {k: v - a * (g[k].reshape(v.shape) + lam * (v - anchor[k]))
                     for k, v in theta.items()}
        up = theta
        if k_frac is not None:
            up, new_ef = {}, {}
            for k, v in theta.items():
                sent, new_ef[k] = topk_ef(_flat2({k: v - anchor[k]}, 2)[k],
                                          _flat2({k: ef_dev[k]}, 2)[k],
                                          k_frac)
                up[k] = anchor[k] + sent.reshape(v.shape)
                new_ef[k] = new_ef[k].reshape(v.shape)
            ef_dev = new_ef
        w = {k: (1 - eta * lam - eta * gamma) * v + eta * gamma * x[k]
             + lam * eta * up[k].mean(1) for k, v in w.items()}
    if k_frac is None:
        w_bar = {k: v.mean(0) for k, v in w.items()}
    else:
        w_bar, new_ef = {}, {}
        for k, v in w.items():
            sent, new_ef[k] = topk_ef(v - x[k], ef_team[k], k_frac)
            w_bar[k] = (x[k] + sent).mean(0)
        ef_team = new_ef
    x_new = {k: (1 - beta * gamma) * v + beta * gamma * w_bar[k]
             for k, v in x.items()}
    out = {"x": x_new, "w": w, "theta": theta}
    if k_frac is not None:
        out.update(ef_dev=ef_dev, ef_team=ef_team)
    return out


def train_loss(state: dict, train: dict) -> float:
    """The round's eval of the device models: their mean train loss."""
    theta = state["theta"]
    m, n = theta[next(iter(theta))].shape[:2]
    flat = {k: v.reshape((m * n,) + v.shape[2:]) for k, v in theta.items()}
    tx, ty = (train[k].reshape((m * n,) + train[k].shape[2:]) for k in "xy")
    with torch.no_grad():
        return float(device_losses(flat, tx, ty).mean())
