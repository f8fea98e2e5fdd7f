#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold every
kernel of it against its plain PyTorch version.

    python3 chip_smoke.py            # the whole check, on one card
    python3 chip_smoke.py --profile  # + one profiled round, top kernels

Phases, each printing its lines; any failure raises and exits non-zero:

  1. environment: torch, the card, ``nvidia-smi`` name and power limit;
     TF32 off for float32 matmuls and convolutions.
  2. build: nvcc for every kernel source, all at once; the -Xptxas -v
     report (registers, spills).
  3. kernel check at the main path's shapes: each kernel against its plain
     version on the card (max abs / rel error within the stated
     tolerance), its time by CUDA events over many launches, the plain
     version's time (each with the L2 cache cold), and the least time
     the card could take.
  4. main path: ``run_scenario("fig2/fmnist/cnn/permfl", rounds=3)`` on the
     card at the registered size (4 teams x 10 devices, paper CNN at its
     published widths, K=5, L=10), with every launch count set to 0 just
     before and read just after: each kernel must have run, prox_update
     exactly rounds*K*L times.
  5. path consistency: one round from the same state through the kernels
     and through the plain versions; the states must agree.
  6. the ``kernels`` JSON line, then the ``ok`` JSON line last.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENARIO = "fig2/fmnist/cnn/permfl"
ROUNDS = 3
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL = {"float32": 1e-6, "bfloat16": 2e-2}
TIMED_LAUNCHES = 200
SLEEP_CYCLES = 100_000_000       # ~50 ms at the H100's 1.98 GHz boost
L2_FLUSH_BYTES = 256 * 2**20     # > 5x the H100's 50 MB L2


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_time_ms(fn, iters):
    """Device time of one call of ``fn`` with the L2 cache cold: the
    median over ``iters`` calls, each preceded on the stream by zeroing a
    buffer five times the L2's size and bracketed alone by CUDA events.
    The card first sleeps ~50 ms on the stream while the host queues all
    the calls, so the events time the device, not the host's launch
    rate (and the card's clocks have ramped up)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in events)
    return times[iters // 2]


def max_errors(got, want):
    """(max abs error, max relative error), compared in float32."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rel = diff / w.abs().clamp_min(1e-30)
    return float(diff.max()), float(rel.max())


def within(got, want, tol):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


def phase_environment():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say("env", f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; tf32 off")
    print(smi[0], flush=True)
    return smi[0]


def phase_build():
    from repro_torch.kernels.build import KERNEL_SOURCES, build, build_log

    t0 = time.perf_counter()
    libs = build()
    say("build", f"{len(libs)} kernel(s) built in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{n} -> {p.name}" for n, p in libs.items()))
    for name in KERNEL_SOURCES:
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")


def phase_kernel_check(layout, m, n):
    """prox_update at the main path's shapes: the device tier (M*N, P) in
    a padded (M*N, S) buffer, the anchor the team tier (M, P)."""
    import torch

    from repro_torch.kernels.prox_update import prox_step_

    rows, p, s = m * n, layout.size, layout.stride
    gen = torch.Generator(device="cuda").manual_seed(0)

    def buf(r, dtype):
        b = torch.zeros(r, s, device="cuda", dtype=dtype)
        b[:, :p] = torch.randn(r, p, device="cuda", generator=gen)
        return b[:, :p]

    cases = [  # (label, dtype, momentum, weight_decay); the first is the
        ("f32", torch.float32, 0.0, 0.0),        # main path's own
        ("bf16", torch.bfloat16, 0.0, 0.0),
        ("f32+momentum+wd", torch.float32, 0.9, 0.01),
    ]
    out = {}
    for label, dtype, mu, wd in cases:
        theta, grad, w = buf(rows, dtype), buf(rows, dtype), buf(m, dtype)
        mom = buf(rows, torch.float32) if mu > 0 else None
        kw = dict(alpha=0.01, lam=0.5, momentum=mu, weight_decay=wd)
        t_k, t_p = buf(rows, dtype), buf(rows, dtype)
        t_k.copy_(theta)
        t_p.copy_(theta)
        m_k = m_p = None
        if mom is not None:
            m_k, m_p = buf(rows, torch.float32), buf(rows, torch.float32)
            m_k.copy_(mom)
            m_p.copy_(mom)
        prox_step_(t_k, grad, w, m_k, **kw)
        prox_step_(t_p, grad, w, m_p, mode="torch", **kw)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        abs_err, rel_err = max_errors(t_k, t_p)
        ok = within(t_k, t_p, TOL[name])
        if mom is not None:
            m_abs, _ = max_errors(m_k, m_p)
            abs_err = max(abs_err, m_abs)
            ok = ok and within(m_k, m_p, TOL["float32"])
        if not ok:
            raise AssertionError(f"prox_update {label}: kernel and plain "
                                 f"version disagree (max abs {abs_err})")
        ms = cuda_time_ms(lambda: prox_step_(t_k, grad, w, m_k, **kw),
                          TIMED_LAUNCHES)
        plain_ms = cuda_time_ms(
            lambda: prox_step_(t_p, grad, w, m_p, mode="torch", **kw), 50)
        es = theta.element_size()
        # theta, grad read and theta' written per device row; the anchor
        # read once per team row; the momentum buffer read and written
        moved = (3 * rows + m) * p * es + (2 * rows * p * 4 if mu else 0)
        ops = rows * p * (9 if mu else 7)
        bound_ms = max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        by = "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S \
            else "operations"
        say("kernel", f"prox_update {label} ({rows}x{p}, anchor {m}x{p}): "
            f"max abs err {abs_err:.3g} rel {rel_err:.3g} (tol "
            f"{TOL[name]:g}); kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
            f"({moved / 1e6:.1f} MB by {by}), {bound_ms / ms:.1%} of bound")
        out[label] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by)
    return out


def phase_main_path():
    import torch

    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import (build_scenario, get_scenario,
                                       run_scenario)

    s = get_scenario(SCENARIO)
    hp = s.algo.hparams()
    # the loss of the untrained model run_scenario starts from (seed 0)
    b = build_scenario(s, seed=0, device="cuda")
    loss0 = b.algo.eval(b.algo.init_state(b.params0, b.m, b.n), b.train,
                        b.val, b.metric_fn)["train_loss"]
    del b
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = run_scenario(SCENARIO, rounds=ROUNDS, device="cuda")
    launches = dict(LAUNCHES)
    d = s.data
    say("main", f"{SCENARIO}: {d.m_teams} teams x {d.n_devices} devices, "
        f"S={d.samples_per_device}, K={hp.k_team}, L={hp.l_local}, "
        f"{ROUNDS} rounds on {res.device}")
    for t, (pm, tm, gm, loss, sec) in enumerate(zip(
            res.pm_acc, res.tm_acc, res.gm_acc, res.train_loss,
            res.round_seconds), 1):
        say("main", f"round {t}: PM {pm:.4f} TM {tm:.4f} GM {gm:.4f} "
            f"train_loss {loss:.4f}; {sec:.3f} s (host clock to "
            f"synchronize, eval included)")
    peak = torch.cuda.max_memory_allocated() / 2**20
    say("main", f"peak device memory {peak:.1f} MiB; launches {launches}")
    expect = ROUNDS * hp.k_team * hp.l_local
    if launches.get("prox_update") != expect:
        raise AssertionError(f"prox_update launched "
                             f"{launches.get('prox_update')} times on the "
                             f"main path, expected {expect}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} did not run on the main "
                                 "path")
    hist = res.pm_acc + res.tm_acc + res.gm_acc + res.train_loss
    if len(res.pm_acc) != ROUNDS or not all(map(math.isfinite, hist)):
        raise AssertionError(f"bad metric history: {hist}")
    if not all(0.0 <= a <= 1.0 for a in res.pm_acc + res.tm_acc
               + res.gm_acc):
        raise AssertionError("accuracy outside [0, 1]")
    say("main", f"train loss of the untrained model {loss0:.4f}")
    if not res.train_loss[-1] < loss0:
        raise AssertionError(f"training did not lower the loss "
                             f"{loss0} -> {res.train_loss}")
    st = res.state
    if st.theta.shape != (d.m_teams, d.n_devices, st.layout.stride) or \
            st.layout.size != 206_922:
        raise AssertionError(f"unexpected state shape {st.theta.shape}")
    return res, launches


def phase_consistency():
    """One round from the same state through the kernel and through the
    plain version, on the card."""
    import torch

    from repro_torch.core import permfl as P
    from repro_torch.scenarios import build_scenario

    b = build_scenario(SCENARIO, seed=1, device="cuda")
    hp = b.scenario.algo.hparams()
    state = P.init_state(b.params0, b.m, b.n)
    out = {}
    for mode in (None, "torch"):
        out[mode] = P.permfl_round(state, b.train, hp, b.loss_fn,
                                   m_teams=b.m, n_devices=b.n, mode=mode)
    torch.cuda.synchronize()
    worst = max(float((getattr(out[None], t) - getattr(out["torch"], t))
                      .abs().max()) for t in ("x", "w", "theta"))
    say("consistency", f"one round kernel vs plain path: max |diff| over "
        f"x, w, theta = {worst:.3g} (tol 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError("kernel and plain paths disagree")


def phase_profile():
    """One more round under torch.profiler: device time by kernel and the
    device's busy share of the round's host-clock time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import permfl as P
    from repro_torch.scenarios import build_scenario

    b = build_scenario(SCENARIO, seed=2, device="cuda")
    hp = b.scenario.algo.hparams()
    state = P.init_state(b.params0, b.m, b.n)
    P.permfl_round(state, b.train, hp, b.loss_fn, m_teams=b.m,
                   n_devices=b.n)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P.permfl_round(state, b.train, hp, b.loss_fn, m_teams=b.m,
                   n_devices=b.n)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        P.permfl_round(state, b.train, hp, b.loss_fn, m_teams=b.m,
                       n_devices=b.n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: an operator's own row repeats the time of
    # the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    say("profile", f"one round: {plain_wall:.3f} s host clock unprofiled, "
        f"{wall:.3f} s profiled; kernels {busy:.3f} s of device time, "
        f"busy {busy / plain_wall:.1%} of the unprofiled round "
        f"({busy / wall:.1%} of the profiled one); "
        f"{sum(e.count for e in rows)} kernel launches")
    for e in rows[:15]:
        say("profile", f"{e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.flat import Layout
    from repro_torch.models.paper_models import init_params
    from repro_torch.scenarios import get_scenario

    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    d = get_scenario(SCENARIO).data
    layout = Layout.of(init_params(CNN, torch.Generator().manual_seed(0)))
    checks = phase_kernel_check(layout, d.m_teams, d.n_devices)
    _, launches = phase_main_path()
    phase_consistency()
    if "--profile" in argv:
        phase_profile()
    main_case = checks["f32"]
    say("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "prox_update", "route": "cuda",
        "source": "src/repro_torch/kernels/prox_update/csrc/prox_update.cu",
        "replaces": "src/repro/kernels/prox_update/prox_update.py:22",
        "launches": launches["prox_update"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
