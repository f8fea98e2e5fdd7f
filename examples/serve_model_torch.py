"""Batched serving on the PyTorch port: prefill + autoregressive decode
with a KV/state cache, as ``examples/serve_model.py`` serves in JAX.

    PYTHONPATH=src python examples/serve_model_torch.py --arch rwkv6-7b \\
        --new 24 [--device cuda|cpu]

Loads a REDUCED variant of any registered arch (dense KV cache, RWKV or
Mamba recurrent state, or Whisper cross-attention -- all the cache
families), generates continuations for a batch of prompts on the card
(the attention, router and scan kernels; ``--device cpu``: their plain
versions), and reports tokens/s.

The *personalized* path (DESIGN.md §12):

    PYTHONPATH=src python examples/serve_model_torch.py --personalized

trains a tiny PerMFL scenario, exports the (team, device)-keyed
``ModelStore`` (exact bit-pattern deltas against each team's anchor),
round-trips it through disk, and serves one batch where every request
carries its own (team, device) tag -- including an unknown device and an
unknown team, which fall back to the team anchor and the global model.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.serve.llm import cache_kind, run

# one known device, a second known device, an unknown device (team
# fallback), an unknown team (global fallback)
TEAMS, DEVICES = np.array([0, 1, 0, 9]), np.array([0, 2, 7, 0])


def personalized_demo(path=None, device=DEFAULT_DEVICE):
    """Train -> export ModelStore -> reload -> serve a tagged batch.
    Returns the served rows as (team, device, tier, class) and the device
    tier's bytes."""
    from repro_torch.models import paper_models
    from repro_torch.scenarios import SCENARIOS, build_scenario, run_scenario
    from repro_torch.serve import ModelStore, PersonalizedServer

    path = path or os.path.join(tempfile.gettempdir(), "permfl_store.zip")
    s = SCENARIOS["table1/mnist/mclr/permfl"].scaled(
        m_teams=2, n_devices=3, samples_per_device=16, rounds=2)
    res = run_scenario(s, seed=0, device=device)
    b = build_scenario(s, seed=0, device=device)

    store = ModelStore.from_result(b.algo, res, m=b.m, n=b.n)
    store.save(path)
    store = ModelStore.load(path, device=device)
    nbytes = store.device_tier_nbytes()
    print(f"store: {b.m}x{b.n} devices, encoding={store.encoding}, "
          f"device tier {nbytes / 1e3:.0f} kB -> {path}")

    server = PersonalizedServer(
        store, lambda p, x: paper_models.apply(p, b.config, x[:, None])[:, 0])
    xv = b.val["x"]
    xs = xv.reshape((-1,) + tuple(xv.shape[3:]))[:4]
    logits = server.serve(TEAMS, DEVICES, xs)
    rows = []
    for t, d, row in zip(TEAMS, DEVICES, logits.cpu()):
        tier = ("device" if d < b.n and t < b.m
                else "team" if t < b.m else "global")
        rows.append((int(t), int(d), tier, int(row.argmax())))
        print(f"  request (team={t}, device={d}) -> {tier}-tier model, "
              f"class {rows[-1][3]}")
    return rows, nbytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--sample", default="greedy", choices=["greedy", "temp"])
    ap.add_argument("--personalized", action="store_true",
                    help="run the personalized (team, device) store demo "
                         "instead of the LLM decode loop")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    if args.personalized:
        return personalized_demo(device=args.device)

    torch.set_float32_matmul_precision("highest")     # no TF32 (the default)
    # random weights (seed 0) and prompts (seed 1) of the reduced config,
    # vocab 512; a 2-token warm-up, then the timed generate
    out, dt = run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                  new=args.new, sample=args.sample, device=args.device)

    cfg = get_reduced_config(args.arch)
    print(f"arch={args.arch} family={cfg.family} cache={cache_kind(cfg)}")
    for i, row in enumerate(out.tolist()):
        print(f"  request {i}: {row}")
    dev = out.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"{args.batch * args.new} tokens in {dt:.2f}s = "
          f"{args.batch * args.new / dt:.1f} tok/s (reduced model, {where})")
    return out


if __name__ == "__main__":
    main()
