"""Mamba (S6) mixer, the SSM layer of Jamba's hybrid stack (the port of
``repro/models/mamba.py``).

Selective state space: input-dependent (dt, B, C), diagonal A.
    h_t = exp(dt_t * A) h_{t-1} + dt_t B_t x_t
    y_t = C_t . h_t + D x_t
The full sequence (and a prefill) runs a time scan carrying the float32
(b, d_in, d_state) state; a decode step is one recurrence step against
the cache: the conv window (the last ``d_conv - 1`` conv inputs, in the
cache dtype) and the float32 SSM state, both written in place.

The selective scan of the full sequence goes through
``kernels/mamba_scan`` (the reference runs an XLA ``lax.scan`` and has
no Pallas kernel here): the hand-written CUDA kernel for CUDA tensors, a
prefill's as a training pass's, with a backward kernel under a gradient;
its plain version on the CPU, which computes the elementwise terms,
exp(dt * A) and dt * x * B, and the read-out y = C . h for a block of
``SCAN_BLOCK`` steps at once (the same numbers: each is elementwise or a
per-step product) and the recurrence one multiply-add a step. A decode
step's recurrence is torch ops (``_step``).

The reference's numerics are kept where they are easy to lose:
``A_log``, ``D`` and ``dt_bias`` are float32 leaves in a bfloat16 tree;
``dt_bias`` is cast to the activation dtype before the softplus; the
scan multiplies dt * x in float32, while a decode step multiplies it in
the activation dtype and casts afterwards; the prefill's conv is a sum
of ``d_conv`` shifted products in the activation dtype, the decode's an
einsum over the window in the cache dtype; y is rounded to the
activation dtype at every step before ``+ x * D``. Mixed types promote
as JAX promotes them (``layers.promoted_matmul`` for the products).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba_scan
from repro_torch.models import layers

__all__ = ["SCAN_BLOCK", "init_mamba_cache", "mamba_apply", "mamba_decode",
           "mamba_init"]

# steps whose elementwise terms one scan block computes at once: at
# Jamba's widths (b 4, d_in 16,384, d_state 16) each float32 (block, b,
# d_in, d_state) buffer is block x 4 MiB
SCAN_BLOCK = 64

_mm = layers.promoted_matmul


def _dims(cfg):
    """(d_in, dt_rank, d_state, d_conv) of the config's mixer."""
    d_in = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_in, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


def mamba_init(gen, cfg, dtype=torch.float32, lead=()):
    """``in_proj`` (d, 2 d_in), ``conv_w`` (d_conv, d_in) normal /
    sqrt(d_conv), ``conv_b`` zeros, ``x_proj`` (d_in, dt_rank + 2
    d_state), ``dt_proj`` (dt_rank, d_in), ``out_proj`` (d_in, d) in
    ``dtype``; ``dt_bias`` log(expm1(0.01)), ``A_log`` log(1..d_state)
    per row and ``D`` ones, float32 whatever ``dtype``. ``lead``
    prepends stacked axes."""
    d = cfg.d_model
    d_in, dt_rank, d_state, d_conv = _dims(cfg)
    dev, lead = gen.device, tuple(lead)
    f32 = torch.float32
    a = torch.arange(1, d_state + 1, dtype=f32, device=dev)
    dt_bias = torch.log(torch.expm1(torch.tensor(0.01, dtype=f32)))
    return {
        "in_proj": layers.dense_init(gen, d, 2 * d_in, dtype, lead=lead),
        "conv_w": layers.normal_init(gen, lead + (d_conv, d_in),
                                     layers._f32(1.0 / math.sqrt(d_conv)),
                                     dtype),
        "conv_b": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "x_proj": layers.dense_init(gen, d_in, dt_rank + 2 * d_state, dtype,
                                    lead=lead),
        "dt_proj": layers.dense_init(gen, dt_rank, d_in, dtype, lead=lead),
        "dt_bias": torch.full(lead + (d_in,), float(dt_bias), dtype=f32,
                              device=dev),
        "A_log": torch.log(a).expand(lead + (d_in, d_state)).contiguous(),
        "D": torch.ones(lead + (d_in,), dtype=f32, device=dev),
        "out_proj": layers.dense_init(gen, d_in, d, dtype, lead=lead),
    }


def init_mamba_cache(cfg, batch, dtype=torch.float32, device="cpu",
                     lead=()):
    """{"conv"}: zeros (``lead`` +) (batch, d_conv - 1, d_in) in
    ``dtype`` (the conv window); {"ssm"}: zeros (batch, d_in, d_state)
    float32 (the SSM state)."""
    d_in, _, d_state, d_conv = _dims(cfg)
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(lead + (batch, d_in, d_state),
                           dtype=torch.float32, device=device),
    }


def _ssm_params(params, xc, cfg):
    """xc (..., d_in), the conv output -> (dt, B, C), the input-dependent
    parameters: dt = softplus(dt_low @ dt_proj + dt_bias), the bias cast
    to dt_low's dtype first."""
    _, dt_rank, d_state, _ = _dims(cfg)
    proj = _mm(xc, params["x_proj"])
    dt, b_mat, c_mat = proj.split([dt_rank, d_state, d_state], dim=-1)
    bias = params["dt_bias"].to(dt.dtype)
    dt = F.softplus(_mm(dt, params["dt_proj"]) + bias)
    return dt, b_mat, c_mat


def _conv(xp, params, s):
    """The prefill's causal depthwise conv and its SiLU: xp (b, d_conv - 1
    + s, d_in), the window-prefixed input -> (b, s, d_in). The ``d_conv``
    shifted products summed in order, in the promoted type."""
    w = params["conv_w"]
    xc = xp[:, 0:s] * w[0]
    for i in range(1, w.shape[0]):
        xc = xc + xp[:, i:i + s] * w[i]
    return F.silu(xc + params["conv_b"])


def _conv_step(window, params):
    """A decode step's conv and its SiLU: window (b, d_conv, d_in) in the
    cache dtype -> (b, d_in)."""
    xc = torch.einsum("bcd,cd->bd", window,
                      params["conv_w"].to(window.dtype))
    return F.silu(xc + params["conv_b"])


def _step(h, xc, dt, b_mat, c_mat, a, out_dtype):
    """One recurrence step of a decode: h (b, d_in, N) float32 -> (y (b,
    d_in) in ``out_dtype``, the new state). dt * x in dt's type, then
    cast."""
    da = torch.exp(dt.float()[..., None] * a)
    h = da * h + (dt * xc).float()[..., None] * b_mat.float()[:, None, :]
    return torch.einsum("bdn,bn->bd", h, c_mat.float()).to(out_dtype), h


def _scan(xc, dt, b_mat, c_mat, a, h0, block, out_dtype, mode=None):
    """The selective scan over s steps (``mamba_scan.scan``: the kernel for
    CUDA tensors, differentiable). xc, dt (b, s, d_in); b_mat, c_mat (b,
    s, N); a (d_in, N) float32; h0 (b, d_in, N) float32 (read, not
    written); ``block`` the plain version's steps a block. Returns (y (b,
    s, d_in) in ``out_dtype``, the state after the last step (b, d_in, N)
    float32)."""
    return mamba_scan.scan(xc, dt, b_mat, c_mat, a, h0, segment=block,
                           out_dtype=out_dtype, mode=mode)


def mamba_apply(params, cfg, x, cache=None, mode=None):
    """Full-sequence Mamba. x: (b, s, d) -> (y (b, s, d), cache or None).
    ``mode`` is the kernels' dispatch mode (None, or "torch" for the plain
    scan on any device).

    With a ``cache`` (prefill semantics) the conv starts from its window
    and the scan from its state, and the cache is written in place: the
    last ``d_conv - 1`` rows of the window-prefixed conv input (cast to
    the cache dtype) and the state after the last step. ``SCAN_BLOCK``
    steps share one computation of the elementwise terms (see the module
    docstring); the output does not depend on it."""
    b, s, _ = x.shape
    d_in, _, d_state, d_conv = _dims(cfg)
    xr, z = _mm(x, params["in_proj"]).chunk(2, dim=-1)        # (b, s, d_in)

    # causal depthwise conv1d (its history from the cache if given)
    if cache is not None:
        xp = torch.cat([cache["conv"].to(xr.dtype), xr], dim=1)
    else:
        xp = F.pad(xr, (0, 0, d_conv - 1, 0))
    xc = _conv(xp, params, s)

    dt, b_mat, c_mat = _ssm_params(params, xc, cfg)
    a = -torch.exp(params["A_log"])                            # (d_in, N)
    h0 = (cache["ssm"] if cache is not None else
          torch.zeros((b, d_in, d_state), dtype=torch.float32,
                      device=x.device))
    # the seam's positional call; the mode by keyword only when one is
    # asked for
    kw = {} if mode is None else {"mode": mode}
    y, h = _scan(xc, dt, b_mat, c_mat, a, h0, min(SCAN_BLOCK, s), x.dtype,
                 **kw)
    y = y + xc * params["D"].to(x.dtype)
    y = y * F.silu(z)
    if cache is not None:
        cache["conv"].copy_(xp[:, xp.shape[1] - (d_conv - 1):])
        cache["ssm"].copy_(h)
    return _mm(y, params["out_proj"]), cache


def mamba_decode(params, cfg, x, cache):
    """One-token step. x: (b, 1, d); ``cache`` from
    :func:`init_mamba_cache`, written in place (the window shifted by the
    new conv input, the state one step on). Returns (y (b, 1, d),
    cache)."""
    xr, z = _mm(x[:, 0, :], params["in_proj"]).chunk(2, dim=-1)   # (b, d_in)
    window = torch.cat([cache["conv"], xr[:, None, :].to(cache["conv"].dtype)],
                       dim=1)                               # (b, d_conv, d_in)
    xc = _conv_step(window, params)
    dt, b_mat, c_mat = _ssm_params(params, xc, cfg)
    y, h = _step(cache["ssm"], xc, dt, b_mat, c_mat,
                 -torch.exp(params["A_log"]), x.dtype)
    y = y + xc * params["D"].to(x.dtype)
    y = y * F.silu(z)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(h)
    return _mm(y, params["out_proj"])[:, None, :], cache
