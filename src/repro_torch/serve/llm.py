"""Batched LLM serving from the command line: prefill + autoregressive
decode with a cache, on a REDUCED variant of a registered arch (the
port of ``examples/serve_model.py``'s LLM path).

    python -m repro_torch.serve.llm --arch deepseek-moe-16b
    python -m repro_torch.serve.llm --arch phi3-mini-3.8b --device cpu
    python -m repro_torch.serve.llm --arch rwkv6-7b --device cpu
    python -m repro_torch.serve.llm --arch whisper-small --device cpu
    python -m repro_torch.serve.llm --arch qwen2-vl-2b --device cpu
    python -m repro_torch.serve.llm --arch jamba-1.5-large-398b --device cpu

Options: ``--batch 4 --prompt-len 32 --new 16 --sample greedy|temp``,
as the reference's. Random weights (seed 0) and prompts (seed 1), vocab
512; it generates twice (the first warms up) and prints the tokens and
tokens/s of the second, with the cache kind as the reference names it
(``recurrent-state`` for the attention-free ``ssm`` family, rwkv6-7b;
``hybrid`` for Jamba's attention/Mamba/MoE stack; ``kv`` otherwise). The prompts are the
reference's (:func:`prompts`): a VLM's are patch embeddings with M-RoPE
positions, an encoder-decoder's tokens come with frame embeddings for its
encoder. Without ``--device cpu`` it runs on the card and raises without
one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.device import DEFAULT_DEVICE, resolve_device, synchronize
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine

__all__ = ["cache_kind", "main", "prompts", "run", "timed_generate"]

VOCAB = 512


def cache_kind(cfg) -> str:
    """The cache the family serves from, as the reference's CLI prints
    it: "recurrent-state" (ssm), "hybrid" (hybrid) or "kv"."""
    if cfg.family == "ssm":
        return "recurrent-state"
    return "hybrid" if cfg.family == "hybrid" else "kv"


def prompts(cfg, batch, prompt_len, gen):
    """The prompts of ``examples/serve_model.py``, drawn from ``gen`` on
    its device: tokens (batch, prompt_len) int32 in the vocabulary; for a
    VLM in their place embeds (batch, prompt_len, d) * 0.2 with M-RoPE
    positions ``arange(prompt_len)`` in all three components; for an
    encoder-decoder also enc_frames (batch, encoder_seq_len, d) * 0.2."""
    dev = gen.device
    if cfg.family == "vlm":
        pos = torch.arange(prompt_len, dtype=torch.int32, device=dev)
        out = {"embeds": torch.randn(batch, prompt_len, cfg.d_model,
                                     generator=gen, device=dev) * 0.2,
               "mrope_positions": pos[None, :, None].repeat(batch, 1, 3)}
    else:
        out = {"tokens": torch.randint(0, cfg.vocab_size,
                                       (batch, prompt_len), generator=gen,
                                       device=dev, dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        out["enc_frames"] = torch.randn(batch, cfg.encoder_seq_len,
                                        cfg.d_model, generator=gen,
                                        device=dev) * 0.2
    return out


def timed_generate(cfg, params, prompt, *, new=16, sample="greedy",
                   device=DEFAULT_DEVICE):
    """Serve ``prompt`` (a :func:`prompts` dict) from ``params`` of
    ``cfg`` with a cache of the prompt's length plus ``new``: a 2-token
    warm-up, then the timed ``generate``. Returns (tokens (batch, new)
    int32, its seconds, synchronized)."""
    dev = resolve_device(device)
    first = prompt["embeds"] if "embeds" in prompt else prompt["tokens"]
    engine = ServeEngine(cfg=cfg, params=params,
                         max_len=first.shape[1] + new, sample=sample,
                         device=dev)
    engine.generate(prompt, max_new_tokens=2)                 # warm-up
    synchronize(dev)
    t0 = time.perf_counter()
    out = engine.generate(prompt, max_new_tokens=new)
    synchronize(dev)
    return out, time.perf_counter() - t0


def run(arch, *, batch=4, prompt_len=32, new=16, sample="greedy",
        device=DEFAULT_DEVICE):
    """Serve the reduced ``arch``: returns (tokens (batch, new) int32,
    seconds of the timed ``generate``)."""
    cfg = get_reduced_config(arch).replace(vocab_size=VOCAB)
    dev = resolve_device(device)
    params = M.init_params(0, cfg, device=dev)
    prompt = prompts(cfg, batch, prompt_len,
                     torch.Generator(device=dev).manual_seed(1))
    return timed_generate(cfg, params, prompt, new=new, sample=sample,
                          device=dev)


def main(argv=None) -> int:
    """The command line (see the module docstring)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.llm")
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--sample", default="greedy", choices=["greedy", "temp"])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    torch.set_float32_matmul_precision("highest")     # no TF32 (the default)
    out, sec = run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                   new=args.new, sample=args.sample, device=args.device)
    cfg = get_reduced_config(args.arch)
    dev = out.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={args.arch} family={cfg.family} cache={cache_kind(cfg)}")
    for i, row in enumerate(out.tolist()):
        print(f"  request {i}: {row}")
    n = args.batch * args.new
    print(f"{n} tokens in {sec:.3f}s = {n / sec:.1f} tok/s (reduced model, "
          f"{where})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
