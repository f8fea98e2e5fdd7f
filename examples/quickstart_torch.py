"""Quickstart on the PyTorch port: PerMFL on a non-IID federated image
problem, as ``examples/quickstart.py`` runs it in JAX.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

Every experiment is a named *scenario* -- one serializable spec covering
data x topology x model x algorithm x comm. The paper's setting (4 teams
x 10 devices, each device holding two classes) is
``table1/mnist/mclr/permfl``; ``run_scenario`` runs it on the card (the
default: the device steps launch the ``prox_update`` kernel, the top-10%
uplinks the ``ef_topk`` select) or, with ``--device cpu``, through the
kernels' plain versions. Browse the catalog:

    PYTHONPATH=src python -m repro_torch.scenarios list
"""
import argparse

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.scenarios import SCENARIOS, build_scenario, run_scenario


def quickstart(rounds=10, device=DEFAULT_DEVICE, links=None):
    """The four runs of the reference's quickstart, printed as it prints
    them: the paper's MCLR cell, its top-10% uplinks, and fp32 against
    top-10% uplinks priced on the wan-cellular system profile. ``links``
    (``run_experiment``'s: round -> (rate, lan, wan)) replaces the two
    system runs' link draws. Returns the four ``FLResult``s."""
    scn = SCENARIOS["table1/mnist/mclr/permfl"]
    b = build_scenario(scn, device=device)
    print(f"scenario {scn.name} (hash {scn.spec_hash()}): "
          f"teams={b.m} devices/team={b.n} "
          f"train shape={b.fd.train_x.shape}")

    res = run_scenario(scn, rounds=rounds, device=device)
    for t, (pm, tm, gm) in enumerate(zip(res.pm_acc, res.tm_acc,
                                         res.gm_acc)):
        print(f"round {t:2d}: PM={pm:.3f} TM={tm:.3f} GM={gm:.3f}")
    print(f"\nPersonalized beats global by "
          f"{100 * (res.pm_acc[-1] - res.gm_acc[-1]):.1f} points "
          f"({res.seconds:.1f}s on {res.device})")

    # the same setting with top-10% sparsified uplinks and error feedback;
    # the CommLedger accounts bytes per tier
    res_c = run_scenario(SCENARIOS["comm/mnist/mclr/topk_10"],
                         rounds=rounds, device=device)
    s = res_c.comm.summary()
    print(f"\ncompressed uplinks (top-10% + EF): PM={res_c.pm_acc[-1]:.3f} "
          f"(vs {res.pm_acc[-1]:.3f} uncompressed)")
    print(f"moved {s['total_bytes'] / 1e6:.1f} MB total vs "
          f"{s['uncompressed_bytes'] / 1e6:.1f} MB at fp32 "
          f"(uplink shrunk {s['uplink_ratio']:.0f}x; "
          f"WAN up {s['wan_up_bytes'] / 1e6:.2f} MB, "
          f"LAN up {s['lan_up_bytes'] / 1e6:.2f} MB)")

    # bytes priced in simulated wall-clock seconds on a cellular WAN
    t_full = run_scenario(SCENARIOS["comm/mnist/mclr/uncompressed"],
                          rounds=rounds, system="wan-cellular", links=links,
                          device=device)
    t_comp = run_scenario(SCENARIOS["comm/mnist/mclr/topk_10"],
                          rounds=rounds, system="wan-cellular", links=links,
                          device=device)
    print(f"\non wan-cellular: fp32 uplinks take "
          f"{t_full.timeline.total_seconds():.1f} simulated s, top-10% "
          f"takes {t_comp.timeline.total_seconds():.1f}s to the same "
          f"round budget")
    t, pm = t_comp.sim_seconds[-1], t_comp.pm_acc[-1]
    print(f"time-to-accuracy curve tail: PM={pm:.3f} @ {t:.1f}s simulated")
    return res, res_c, t_full, t_comp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    return quickstart(device=args.device)


if __name__ == "__main__":
    main()
