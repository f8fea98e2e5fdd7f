"""End-to-end run on the PyTorch port: the paper's experiment, faithful
shape, as ``examples/federated_benchmark.py`` runs it in JAX.

    PYTHONPATH=src python examples/federated_benchmark_torch.py \\
        --dataset fmnist --model cnn --rounds 30 --teams 4 --devices 10 \\
        [--device cuda|cpu]

Builds an ad-hoc ``FLScenario`` from the CLI arguments (the spec type the
registry holds; ``--dump-spec`` prints it as the reference does, with the
same ``spec_hash``), trains PerMFL *and* FedAvg on the same non-IID
partition on the card (``--device cpu``: the kernels' plain versions),
evaluates the personalized/team/global models each round, and writes a
CSV of the convergence curves plus a final comparison line.
``--partitioner dirichlet --alpha 0.3`` switches to Dirichlet label skew;
``--formation worst`` exercises the team-formation ablation;
``--theory-hparams`` takes (alpha, eta, beta, lam, gamma) from Theorem 1.
"""
import argparse
import csv
import dataclasses
import json
import sys

from repro_torch.core.theory import (mclr_constants,
                                     pick_hparams_strongly_convex)
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.scenarios import (AlgoSpec, DataSpec, FLScenario,
                                   ModelSpec, build_scenario, run_scenario)


def scenario_from_args(args) -> FLScenario:
    """The CLI arguments as one declarative spec."""
    tabular = args.dataset == "synthetic"
    if args.model == "cnn" and tabular:
        sys.exit("--model cnn needs an image dataset")
    data = DataSpec(
        dataset=args.dataset,
        partitioner="tabular" if tabular else args.partitioner,
        m_teams=args.teams, n_devices=args.devices,
        samples_per_device=48, strategy=args.formation, alpha=args.alpha)
    # the reference script's name and notes, so that a dumped spec is the
    # reference's byte for byte
    return FLScenario(
        name=f"cli/{args.dataset}/{args.model}",
        data=data, model=ModelSpec(args.model), algo=AlgoSpec("permfl"),
        rounds=args.rounds, team_frac=args.team_frac,
        device_frac=args.device_frac, data_seed=args.seed,
        notes="ad-hoc scenario from examples/federated_benchmark.py")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="fmnist",
                    choices=["mnist", "fmnist", "emnist10", "synthetic"])
    ap.add_argument("--model", default="mclr",
                    choices=["mclr", "cnn", "dnn"])
    ap.add_argument("--partitioner", default="label_skew",
                    choices=["label_skew", "dirichlet", "quantity"])
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="dirichlet concentration (with --partitioner)")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--teams", type=int, default=4)
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--team-frac", type=float, default=1.0)
    ap.add_argument("--device-frac", type=float, default=1.0)
    ap.add_argument("--formation", default="random",
                    choices=["random", "worst", "average"])
    ap.add_argument("--theory-hparams", action="store_true",
                    help="derive (alpha,eta,beta,lam,gamma) from Theorem 1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="CSV path for curves")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the scenario spec as JSON and exit")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    scn = scenario_from_args(args)
    if args.dump_spec:
        print(json.dumps(scn.to_dict(), indent=2))
        return

    if args.theory_hparams and args.model == "mclr":
        b = build_scenario(scn, args.seed, device=args.device)
        cfg = b.config
        # the host copy of the stacked data (the device's is b.train)
        mu, lf = mclr_constants(
            b.fd.train_x.reshape(-1, *cfg.input_shape), cfg.l2_reg)
        th = pick_hparams_strongly_convex(mu, lf, safety=0.9)
        print(f"theory hparams: {th}")
        scn = dataclasses.replace(
            scn, algo=AlgoSpec("permfl", tuple(th.items())))
    hp = scn.algo.hparams()

    print(f"== PerMFL: {scn.rounds} rounds x K={hp.k_team} x L={hp.l_local}"
          f" = {scn.rounds * hp.k_team * hp.l_local} device steps ==")
    res = run_scenario(scn, seed=args.seed, device=args.device)
    print("== FedAvg baseline ==")
    fedavg = dataclasses.replace(
        scn, algo=AlgoSpec("fedavg", (("lr", hp.alpha * 3),
                                      ("local_steps",
                                       hp.k_team * hp.l_local))),
        team_frac=1.0, device_frac=1.0)
    ref = run_scenario(fedavg, seed=args.seed, device=args.device)

    rows = [("round", "permfl_pm", "permfl_tm", "permfl_gm", "fedavg_gm")]
    for t in range(len(res.pm_acc)):
        rows.append((t, res.pm_acc[t], res.tm_acc[t], res.gm_acc[t],
                     ref.gm_acc[min(t, len(ref.gm_acc) - 1)]))
        print(f"round {t:3d}  PM {res.pm_acc[t]:.3f}  TM {res.tm_acc[t]:.3f}"
              f"  GM {res.gm_acc[t]:.3f} | FedAvg {rows[-1][4]:.3f}")
    if args.out:
        with open(args.out, "w", newline="") as f:
            csv.writer(f).writerows(rows)
        print(f"curves -> {args.out}")
    print(f"\nfinal: PerMFL(PM) {res.pm_acc[-1]:.3f} vs FedAvg(GM) "
          f"{ref.gm_acc[-1]:.3f}  (paper's claim: PM wins under non-IID)")
    return res, ref


if __name__ == "__main__":
    main()
