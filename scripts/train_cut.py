#!/usr/bin/env python3
"""Train one LM cut to some depth at every published width on the card,
as ``chip_smoke.py``'s training phases do, to find how deep a cut fits.

    python3 scripts/train_cut.py rwkv6-7b 16     # from the repository root
    python3 scripts/train_cut.py jamba-1.5-large-398b 3

Draws ``arch`` (deepseek-moe-16b, rwkv6-7b or jamba-1.5-large-398b) with
``num_layers`` replaced in bf16 on the card, its parameters and leaves
held to the reference tree's of that cut (``chip_smoke.py::cut_tree``;
Jamba's ``jamba_cut`` / ``jamba_tree``: one block of attn_period =
num_layers positions, the attention layer at num_layers // 2, the rest
Mamba, every FFN dense; at least 2 layers), and runs
``chip_smoke.py::run_training``: one AdamW step and two tier rounds on 4 x
1,024 tokens, each kernel launched exactly its count a pass (attention
forward and backward, the router and its backward, the WKV scan and its
backward, the selective scan and its backward: one each a layer of that
kind), prox_update once a leaf a local step, finite losses, the tier loss
falling. Prints the card's name and
power limit, then each phase's ms, tokens/s and peak memory; exits
non-zero if a check fails or the peak reaches the card's 80 GB. Needs
one NVIDIA card and ``nvcc``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main(argv) -> int:
    arch, layers = argv[0], int(argv[1])
    from repro_torch.configs import get_config

    if arch == C.JAMBA_ARCH:
        if layers < 2:
            raise SystemExit(f"{arch}: a cut of at least 2 layers (one "
                             f"attention layer, the rest Mamba)")
        cut = C.jamba_cut(layers)
        n_params, n_leaves = C.jamba_tree(layers)
    elif arch in C.CUT_TREES:
        cut = dict(num_layers=layers)
        n_params, n_leaves = C.cut_tree(arch, layers)
    else:
        raise SystemExit(f"{arch}: no reference tree size for its cuts; "
                         f"one of {sorted(C.CUT_TREES) + [C.JAMBA_ARCH]}")
    cfg = get_config(arch).replace(**cut)
    kinds = cfg.layer_kinds()
    if arch == C.JAMBA_ARCH:
        per_pass = {"flash_attention": kinds.count("attn"),
                    "flash_attention_bwd": kinds.count("attn"),
                    "mamba_scan": kinds.count("mamba"),
                    "mamba_scan_bwd": kinds.count("mamba")}
    elif cfg.family == "ssm":
        per_pass = {"rwkv6_scan": layers, "rwkv6_scan_bwd": layers}
    else:
        per_pass = {"flash_attention": layers,
                    "flash_attention_bwd": layers}
        moe = sum(cfg.moe_layer_mask()) if cfg.moe.num_experts else 0
        if moe:
            per_pass.update(moe_router=moe, moe_router_bwd=moe)
    C.phase_environment()
    C.phase_build()
    C.run_training(arch, n_params, n_leaves, per_pass, {}, cut)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
