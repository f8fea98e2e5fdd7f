"""Dry run of every (architecture x input shape) on one H100, on fake
tensors: the port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dry.json

Each combination builds its step at the published widths -- the PerMFL
device step (eq. 4 prox-SGD with momentum toward the team anchor, after
a remat forward and backward), or with ``--plain`` vanilla SGD; a
prefill of the whole prompt (logits of the last position); or one decode
token against a full cache -- and runs it once under the op counter
(``repro_torch.roofline.op_analysis``) on fake tensors
(``FakeTensorMode``): nothing is allocated, no card is needed, and the
kernel seams stand in for their kernels, taking the card's path through
the model. Each record gives the counted FLOPs and bytes, the roofline
on the H100's peaks (``repro_torch.roofline``), each kernel family's
launches and work, and the memory the step would hold on the card:
``argument`` (exact), ``output``, ``temp`` (the most bytes live at once
beyond the arguments) and ``peak = argument + temp``, with ``fits``:
peak within the card's memory. At the reference's shapes most
combinations do not fit one card; that is a finding, not a failure.

The only mesh is ``card``: one H100, every axis of size 1. ``--mesh pod``
and ``--mesh multipod`` (the reference's 256 and 512 TPU chips) exit 2,
naming the cards they need. The reference's decode layout policy
(``REPRO_DECODE_FSDP``, a layout across 16 chips) has no meaning on one
card and is not carried.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import active_param_count, param_count
from repro_torch.launch.mesh import (Mesh, batch_axes, hbm_capacity,
                                     make_production_mesh, mesh_batch_size)
from repro_torch.models import model as model_lib
from repro_torch.roofline import analyze, model_flops_decode, \
    model_flops_train
from repro_torch.roofline.op_analysis import analyze_ops
from repro_torch.sharding.specs import (batch_pspecs, cache_pspecs,
                                        param_pspecs, validate_pspecs)

__all__ = ["ACT_DTYPE", "SWA_WINDOW", "build_step_and_args",
           "cache_len_for", "card_mesh", "main", "resolve_config", "run_one"]

SWA_WINDOW = 8192           # sliding window used for dense long_500k
ACT_DTYPE = torch.bfloat16


def card_mesh() -> Mesh:
    """The one-H100 (data, model) mesh the dry run lays its steps on (it
    names the card and touches no CUDA state)."""
    return Mesh(("data", "model"), (1, 1), torch.device("cuda"))


def resolve_config(arch: str, shape_name: str):
    """Arch config adjusted per input shape policy (DESIGN.md §5).

    Returns (cfg, skip_reason | None)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape_name == "long_500k":
        if not cfg.supports_long_decode():
            return cfg, ("enc-dec decoder context is 448 by construction; "
                         "524k decode contradicts the architecture")
        needs_swa = any(k == "attn" for k in cfg.layer_kinds()) and \
            cfg.family not in ("hybrid",)
        if needs_swa:
            cfg = cfg.replace(sliding_window=SWA_WINDOW)
    if shape.kind == "decode" and cfg.is_encoder_decoder and \
            shape_name == "long_500k":
        return cfg, "skip"
    return cfg, None


def cache_len_for(cfg, shape) -> int:
    """The decode cache's slots: the sequence, or under a sliding window
    the window (the live KV state of a ring buffer)."""
    if cfg.sliding_window > 0:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def build_step_and_args(cfg, shape, mesh, *, plain=False, fake_mode=None):
    """(step, args, in_specs, out_specs) of one (config x input shape):
    ``step(*args)`` runs it; ``args`` are fake tensors of ``fake_mode``
    (default a new one; run the step inside it) at the published widths;
    the specs are each argument's and output's partition specs on
    ``mesh`` (None: not laid out), validated against it."""
    fm = fake_mode or FakeTensorMode()
    baxes = batch_axes(mesh)
    baxes_spec = baxes if len(baxes) > 1 else baxes[0]
    mesh_b = mesh_batch_size(mesh)
    p_specs = model_lib.param_specs(cfg, dtype=ACT_DTYPE, fake_mode=fm)
    p_shard = validate_pspecs(p_specs, param_pspecs(p_specs), mesh)

    def specs(tree, pspecs):
        return validate_pspecs(tree, pspecs, mesh)

    if shape.kind == "train":
        from repro_torch.kernels.prox_update import prox_sgd_tree
        from repro_torch.train.optim import tree_map
        from repro_torch.train.trainer import value_and_grad

        def step(theta, w, mom, batch):
            lv, grads = value_and_grad(theta, cfg, batch, remat=True)
            if plain:
                theta2 = tree_map(lambda t, g: t - 0.01 * g, theta, grads)
                return theta2, mom, {"loss": lv}
            theta2, mom2 = prox_sgd_tree(theta, grads, w, mom, alpha=0.01,
                                         lam=0.5, momentum=0.9)
            return theta2, mom2, {"loss": lv}

        batch = model_lib.input_specs(cfg, batch=shape.global_batch,
                                      seq_len=shape.seq_len, kind="train",
                                      act_dtype=ACT_DTYPE, fake_mode=fm)
        with fm:
            mom = tree_map(lambda t: torch.empty(t.shape,
                                                 dtype=torch.float32),
                           p_specs)
        m_shard = specs(mom, param_pspecs(mom))
        b_shard = specs(batch, batch_pspecs(batch, batch_axes=baxes_spec))
        return (step, (p_specs, model_lib.param_specs(
            cfg, dtype=ACT_DTYPE, fake_mode=fm), mom, batch),
            (p_shard, p_shard, m_shard, b_shard), (p_shard, m_shard, None))

    if shape.kind == "prefill":
        @torch.no_grad()
        def step(params, batch, cache):
            return model_lib.prefill(params, cfg, batch, cache,
                                     last_only=True)

        batch = model_lib.input_specs(cfg, batch=shape.global_batch,
                                      seq_len=shape.seq_len, kind="prefill",
                                      act_dtype=ACT_DTYPE, fake_mode=fm)
        cache = model_lib.cache_specs(cfg, shape.global_batch,
                                      shape.seq_len, dtype=ACT_DTYPE,
                                      fake_mode=fm)
        b_shard = specs(batch, batch_pspecs(batch, batch_axes=baxes_spec))
        c_shard = specs(cache, cache_pspecs(cache, batch_axes=baxes_spec,
                                            mesh_batch=mesh_b))
        return (step, (p_specs, batch, cache), (p_shard, b_shard, c_shard),
                (None, c_shard))

    # decode: one token at the cache's last slot, attending to all of it
    max_len = cache_len_for(cfg, shape)

    @torch.no_grad()
    def step(params, cache, batch):
        return model_lib.decode_step(params, cfg, cache, batch, max_len - 1)

    batch = model_lib.input_specs(cfg, batch=shape.global_batch,
                                  seq_len=shape.seq_len, kind="decode",
                                  act_dtype=ACT_DTYPE, fake_mode=fm)
    cache = model_lib.cache_specs(cfg, shape.global_batch, max_len,
                                  dtype=ACT_DTYPE, fake_mode=fm)
    b_shard = specs(batch, batch_pspecs(batch, batch_axes=baxes_spec))
    c_shard = specs(cache, cache_pspecs(cache, batch_axes=baxes_spec,
                                        mesh_batch=mesh_b))
    return (step, (p_specs, cache, batch), (p_shard, c_shard, b_shard),
            (None, c_shard))


def run_one(arch: str, shape_name: str, *, plain: bool = False,
            verbose: bool = True) -> dict:
    """One combination's record (module docstring): "status" "ok" with
    its counts, "skipped" with a reason."""
    shape = INPUT_SHAPES[shape_name]
    cfg, skip = resolve_config(arch, shape_name)
    record = {
        "arch": arch, "shape": shape_name, "mesh": "card",
        "params": param_count(get_config(arch)),
        "active_params": active_param_count(get_config(arch)),
    }
    if skip:
        record["status"] = "skipped"
        record["reason"] = skip
        return record

    t0 = time.time()
    fm = FakeTensorMode()
    step, args, _, _ = build_step_and_args(cfg, shape, card_mesh(),
                                           plain=plain, fake_mode=fm)
    with fm:
        counts = analyze_ops(step, *args)
    trace_s = time.time() - t0

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    if shape.kind == "train":
        mflops = model_flops_train(cfg, tokens)
    else:       # prefill and decode: forward only
        mflops = model_flops_decode(cfg, tokens)
    roof = analyze(counts, chips=1, model_flops=mflops)
    argument = counts["argument_bytes"]
    peak = counts["peak_bytes"]
    capacity = hbm_capacity()
    record.update({
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "chips": 1,
        "flops": roof.flops,
        "hbm_bytes": roof.hbm_bytes,
        "collective_bytes": roof.collective_bytes,
        "collectives": roof.collectives,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "dominant": roof.dominant,
        "model_flops": mflops,
        "useful_ratio": roof.useful_ratio,
        "bytes_per_device": {
            "argument": argument,
            "output": counts["output_bytes"],
            "temp": peak - argument,
            "peak": peak,
        },
        "hbm_capacity": capacity,
        "fits": peak <= capacity,
        "kernels": counts["kernels"],
        "aten_ops": counts["aten_ops"],
    })
    if verbose:
        mem = record["bytes_per_device"]
        print(f"== {arch} x {shape_name} x card ==")
        launches = {k: v["launches"] for k, v in counts["kernels"].items()}
        print(f"  trace {trace_s:.1f}s, {counts['aten_ops']} aten ops, "
              f"kernels {launches}")
        print(f"  memory: argument {mem['argument'] / 1e9:.2f} GB, output "
              f"{mem['output'] / 1e9:.2f} GB, temp {mem['temp'] / 1e9:.2f} "
              f"GB, peak {mem['peak'] / 1e9:.2f} GB "
              f"({'fits' if record['fits'] else 'does not fit'} "
              f"{capacity / 1e9:.1f} GB)")
        print(f"  roofline: {roof.summary()}")
    return record


def main(argv=None) -> int:
    """The CLI (module docstring): 0 when every combination ran or was
    skipped, 1 when one failed, 2 for a mesh the card cannot hold."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="card",
                    choices=["card", "pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="vanilla SGD step instead of PerMFL device step")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    if args.mesh != "card":
        try:
            make_production_mesh(multi_pod=args.mesh == "multipod")
        except ValueError as e:
            print(f"dryrun: {e}", file=sys.stderr)
            return 2
    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    t0 = time.time()
    records = []
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, plain=args.plain)
        except Exception as e:  # a failure here is a bug in the port
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": "card",
                   "status": "FAILED", "error": repr(e)}
        records.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    bad = [r for r in records if r["status"] == "FAILED"]
    print(f"\n{len(records) - len(bad)}/{len(records)} combos OK in "
          f"{time.time() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
