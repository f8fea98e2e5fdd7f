"""Public LLM model API of the port: init / forward / loss / prefill /
decode (the port of ``repro/models/model.py``).

Batch conventions, as the reference's:
  * plain LM (dense / moe / ssm / hybrid):
      forward / prefill: {"tokens": (b, s) int}
      decode:            {"tokens": (b, 1) int}
  * VLM (qwen2-vl; the vision frontend is a stub):
      forward / prefill: {"embeds": (b, s, d), "mrope_positions": (b, s, 3)
                          int}
      decode:            {"tokens": (b, 1) int, "mrope_positions": (b, 1, 3)
                          int}
  * audio encoder-decoder (whisper; the conv/mel frontend is a stub):
      forward / prefill: {"enc_frames": (b, encoder_seq_len, d),
                          "tokens": (b, s) int}
      decode:            {"tokens": (b, 1) int} (the cross K/V are cached)

Every function takes ``mode``, the kernels' dispatch mode: None runs the
hand-written kernels for CUDA tensors and their plain versions for CPU
tensors; "torch" runs the plain versions on any device (for comparing
the two paths on the card). ``loss_fn`` is differentiable: autograd runs
through the attention kernel's backward (``flash_attention_bwd``) on the
card, the MoE router's (``moe_router_bwd``), the WKV-6 scan's
(``rwkv6_scan_bwd``) and Mamba's selective scan's (``mamba_scan_bwd``),
and through the plain versions on the CPU; ``remat=True`` checkpoints
each block (``torch.utils.checkpoint``). Under an active span log
(``repro_torch.obs.spans``) :func:`forward` and :func:`loss_fn` record
``embed``, ``blocks`` and ``head`` (the logits, and the loss). Every
family trains: the dense, MoE, RWKV-6 and hybrid attention/Mamba stacks
(phi3, qwen3, deepseek, dbrx, rwkv6, Jamba, ...).
:func:`input_specs`, :func:`param_specs` and :func:`cache_specs` are
the dry run's stand-ins: fake tensors (``FakeTensorMode``) of the
published widths' shapes and types, made without allocating, where the
reference returns ``jax.ShapeDtypeStruct`` trees.
"""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import layers, transformer
from repro_torch.obs.spans import span

__all__ = ["cache_specs", "decode_step", "forward", "init_cache",
           "init_params", "input_specs", "loss_fn", "padded_vocab",
           "param_specs", "prefill"]


def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 128 unless it is one of 16 (the
    reference's rule); pad rows are masked to -1e30 in the logits."""
    v = cfg.vocab_size
    return v if v % 16 == 0 else -(-v // 128) * 128


def init_params(gen, cfg, dtype=torch.float32, device=DEFAULT_DEVICE):
    """Random parameters under the reference's tree ({"embed", "blocks",
    "final_norm", "lm_head"}, and "encoder" for an encoder-decoder), drawn
    on ``device`` (default the card;
    raises without one) from ``gen``: a ``torch.Generator`` on that
    device, or an int seed for one."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters asked on "
                         f"{dev}: draw on the device they live on")
    pv = padded_vocab(cfg)
    p = {
        "embed": layers.embed_init(gen, pv, cfg.d_model, dtype),
        "blocks": transformer.stack_init(gen, cfg, dtype),
        "final_norm": layers.norm_init(cfg, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, cfg.d_model, pv, dtype)
    if cfg.is_encoder_decoder:
        p["encoder"] = transformer.encoder_init(gen, cfg, dtype)
    return p


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=DEFAULT_DEVICE):
    """{"layers": stacked cache} on ``device``, per position of the block:
    attention, the KV cache, zeros (n_blocks, batch, max_len, hkv, hd) in
    ``dtype``; RWKV, the recurrent state, ``tm_last`` / ``cm_last`` zeros
    (n_blocks, batch, d) in ``dtype`` and ``wkv`` zeros (n_blocks, batch,
    h, n, n) float32, whatever ``max_len``; Mamba, ``conv`` zeros
    (n_blocks, batch, d_conv - 1, d_in) in ``dtype`` and ``ssm`` zeros
    (n_blocks, batch, d_in, d_state) float32."""
    return {"layers": transformer.stack_cache(cfg, batch, max_len, dtype,
                                              resolve_device(device))}


def _embed_in(params, cfg, batch):
    if "embeds" in batch:
        return batch["embeds"]
    return params["embed"][batch["tokens"].long()]


def _encode(params, cfg, batch, mode):
    """The encoder's output for an encoder-decoder's ``enc_frames``, else
    None."""
    if not cfg.is_encoder_decoder:
        return None
    return transformer.encoder_apply(params["encoder"], cfg,
                                     batch["enc_frames"], kmode=mode)


def _logits_out(params, cfg, x):
    x = layers.norm_apply(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = layers.promoted_matmul(x, head).float()
    pv = head.shape[-1]
    if pv != cfg.vocab_size:
        keep = torch.arange(pv, device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits, -1e30)
    return logits


def _hidden(params, cfg, batch, remat, mode):
    """The last block's output and the aux loss, under the ``embed`` and
    ``blocks`` spans."""
    with span("embed"):
        x = _embed_in(params, cfg, batch)
    with span("blocks"):
        x, _, aux = transformer.stack_apply(
            params["blocks"], cfg, x, mode="full",
            mrope_positions=batch.get("mrope_positions"),
            enc_out=_encode(params, cfg, batch, mode), kmode=mode,
            remat=remat)
    return x, aux


def forward(params, cfg, batch, *, remat=False, mode=None):
    """Full-sequence forward -> (logits (b, s, V) float32, aux_loss)."""
    x, aux = _hidden(params, cfg, batch, remat, mode)
    with span("head"):
        return _logits_out(params, cfg, x), aux


def loss_fn(params, cfg, batch, *, remat=False, mode=None):
    """Mean next-token cross-entropy + MoE aux loss, differentiable in
    ``params``. Targets of -100 (any negative) are masked."""
    x, aux = _hidden(params, cfg, batch, remat, mode)
    with span("head"):
        logits = _logits_out(params, cfg, x)
        targets = batch["targets"].long()
        mask = (targets >= 0).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
        ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return ce + aux


def prefill(params, cfg, batch, cache, *, last_only=False, mode=None):
    """Forward that also fills the cache in place: the KV cache's slots
    [0, s) (and an encoder-decoder's cross K/V), or the recurrent state
    (an RWKV or Mamba layer's) after the prompt, continued from the state
    the cache holds. Returns
    (logits, cache); ``last_only`` computes the final position's logits
    only (b, 1, V), as serving does."""
    x = _embed_in(params, cfg, batch)
    x, layers_cache, _ = transformer.stack_apply(
        params["blocks"], cfg, x, mode="full", cache=cache["layers"],
        mrope_positions=batch.get("mrope_positions"),
        enc_out=_encode(params, cfg, batch, mode), kmode=mode)
    if last_only:
        x = x[:, -1:, :]
    return _logits_out(params, cfg, x), {"layers": layers_cache}


def decode_step(params, cfg, cache, batch, pos, *, mode=None):
    """One-token decode at cache position ``pos`` (a host int). batch:
    {"tokens": (b, 1)}, and "mrope_positions" (b, 1, 3) for a VLM. Writes
    slot ``pos`` of a KV cache, and the whole recurrent state of an RWKV
    or Mamba layer (which ignores ``pos``), in place.
    Returns (logits (b, 1, V) float32, cache)."""
    x = _embed_in(params, cfg, batch)
    x, layers_cache, _ = transformer.stack_apply(
        params["blocks"], cfg, x, mode="decode", cache=cache["layers"],
        pos=int(pos), mrope_positions=batch.get("mrope_positions"),
        kmode=mode)
    return _logits_out(params, cfg, x), {"layers": layers_cache}


# ---------------------------------------------------------------------------
# fake-tensor stand-ins for the dry run
# ---------------------------------------------------------------------------

def input_specs(cfg, *, batch: int, seq_len: int, kind: str,
                act_dtype=torch.bfloat16, fake_mode: FakeTensorMode = None):
    """Stand-in inputs of an (arch x input shape) step as fake tensors of
    ``fake_mode`` (default a new one; nothing is allocated): the batch
    dict :func:`forward` (kind "train" adds "targets"), :func:`prefill`
    ("prefill") or :func:`decode_step` ("decode") takes; ints int32."""
    i32 = torch.int32
    with fake_mode or FakeTensorMode():
        if kind in ("train", "prefill"):
            spec = {}
            if cfg.family == "vlm":
                spec["embeds"] = torch.empty(batch, seq_len, cfg.d_model,
                                             dtype=act_dtype)
                spec["mrope_positions"] = torch.empty(batch, seq_len, 3,
                                                      dtype=i32)
            elif cfg.is_encoder_decoder:
                spec["enc_frames"] = torch.empty(
                    batch, cfg.encoder_seq_len, cfg.d_model, dtype=act_dtype)
                spec["tokens"] = torch.zeros(batch, seq_len, dtype=i32)
            else:
                spec["tokens"] = torch.zeros(batch, seq_len, dtype=i32)
            if kind == "train":
                spec["targets"] = torch.zeros(batch, seq_len, dtype=i32)
            return spec
        if kind == "decode":
            spec = {"tokens": torch.zeros(batch, 1, dtype=i32)}
            if cfg.family == "vlm":
                spec["mrope_positions"] = torch.zeros(batch, 1, 3, dtype=i32)
            return spec
    raise ValueError(kind)


@functools.lru_cache(maxsize=32)
def _param_shapes(cfg, dtype):
    """:func:`init_params`' tree of (shape, dtype) pairs, drawn once a
    (config, dtype) on fake tensors."""
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape), tree.dtype
    with FakeTensorMode():
        return shapes(init_params(0, cfg, dtype=dtype, device="cpu"))


def param_specs(cfg, dtype=torch.bfloat16, fake_mode: FakeTensorMode = None):
    """:func:`init_params`' tree as fake tensors of ``fake_mode`` (default a
    new one): the published widths' shapes and types, nothing
    allocated."""
    def fake(tree):
        if isinstance(tree, dict):
            return {k: fake(v) for k, v in tree.items()}
        return torch.empty(tree[0], dtype=tree[1])
    with fake_mode or FakeTensorMode():
        return fake(_param_shapes(cfg, dtype))


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                fake_mode: FakeTensorMode = None):
    """:func:`init_cache`'s tree as fake tensors of ``fake_mode`` (default
    a new one), nothing allocated."""
    with fake_mode or FakeTensorMode():
        return init_cache(cfg, batch, max_len, dtype=dtype, device="cpu")
