"""PerMFL at LLM scale on the PyTorch port -- the production "tier mode"
(DESIGN.md §2), as ``examples/tiered_llm_training.py`` runs it in JAX.

    PYTHONPATH=src python examples/tiered_llm_training_torch.py \\
        [--arch phi3-mini-3.8b] [--device cuda|cpu] [--trace-dir DIR]

Runs the tiered PerMFL round (device prox steps -> team update -> server
update, ``repro_torch.train.trainer.make_tier_round``) on a REDUCED
variant of a dense, MoE, RWKV-6, hybrid attention/Mamba (Jamba) or
vision-language (Qwen2-VL, on tokens) architecture, with federated LM
data where each team has its own topic distribution -- the LM analogue
of the paper's label skew. Shows
personalized loss <= global loss on each team's distribution. On the card
(the default) the device steps run through the backward kernels
(attention, the MoE router, the WKV-6 scan, Mamba's selective scan) and
the ``prox_update`` kernel, and the team and server updates through the
``tier_update`` kernel; ``--device cpu`` runs the plain versions.
``--trace-dir DIR`` saves the rounds' spans (``tier_round``,
``local_step``, ``forward``, ``backward``, ``prox_step``,
``team_update``, ``server_update``, and the loss evaluations' forward
parts) there; ``python -m repro_torch.obs report DIR`` prints their
totals by name.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.data.tokens import federated_lm_data
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.obs.spans import owned_log
from repro_torch.train.trainer import make_tier_round

VOCAB = 256
# the dense, MoE, RWKV-6, hybrid attention/Mamba and vision-language
# architectures (Qwen2-VL on tokens alone); whisper-small is left out:
# team_batch builds no enc_frames for its encoder, as in the reference
ARCHS = ("phi3-mini-3.8b", "qwen3-14b", "yi-34b", "qwen1.5-32b",
         "deepseek-moe-16b", "dbrx-132b", "rwkv6-7b",
         "jamba-1.5-large-398b", "qwen2-vl-2b")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCHS)
    ap.add_argument("--teams", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default=None,
                    help="save the rounds' spans here (read them with "
                         "python -m repro_torch.obs report DIR)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced_config(args.arch).replace(vocab_size=VOCAB)
    data = federated_lm_data(np.random.default_rng(0), VOCAB,
                             m_teams=args.teams, n_devices=1,
                             seq_len=args.seq_len, seqs_per_device=8)

    x = M.init_params(0, cfg, device=dev)            # global model
    # every tier starts from x; a round writes no input, so they share it
    thetas = [x] * args.teams
    ws = [x] * args.teams

    round_fn = make_tier_round(cfg, alpha=3e-3, lam=0.5, gamma=1.5,
                               eta=0.03, beta=0.3, l_local=2)

    def team_batch(i):
        return {"tokens": torch.as_tensor(data["tokens"][i, 0], device=dev),
                "targets": torch.as_tensor(data["targets"][i, 0],
                                           device=dev)}

    def loss_of(params, batch):
        with torch.no_grad():
            return float(M.loss_fn(params, cfg, batch))

    with owned_log(args.trace_dir, {"example": "tiered_llm_training",
                                    "arch": args.arch}, "tiered"):
        for t in range(args.rounds):
            xs = []
            for i in range(args.teams):              # pods, in production
                thetas[i], ws[i], xi, metrics = round_fn(
                    thetas[i], ws[i], x, team_batch(i))
                xs.append(xi)
            # server aggregation over the teams (here: a mean)
            x = _mean_trees(xs)
            if t % 10 == 0 or t == args.rounds - 1:
                pm = np.mean([loss_of(thetas[i], team_batch(i))
                              for i in range(args.teams)])
                gm = np.mean([loss_of(x, team_batch(i))
                              for i in range(args.teams)])
                print(f"round {t:3d}: personalized loss {pm:.4f} "
                      f"(ppl {np.exp(pm):7.1f})   global loss {gm:.4f} "
                      f"(ppl {np.exp(gm):7.1f})")
    if args.trace_dir:
        print(f"spans saved: python -m repro_torch.obs report "
              f"{args.trace_dir}")

    assert pm <= gm + 1e-6, "personalized should fit team topics at least as well"
    print("\npersonalized models fit their team's topic better than the "
          "global model -- the paper's mechanism, at LM scale.")
    return pm, gm


def _mean_trees(trees):
    """The leaf-wise mean of parameter trees (nested dicts)."""
    if isinstance(trees[0], dict):
        return {k: _mean_trees([t[k] for t in trees]) for k in trees[0]}
    return sum(trees) / len(trees)


if __name__ == "__main__":
    main()
