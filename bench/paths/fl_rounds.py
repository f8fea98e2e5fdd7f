"""Path ``fl_rounds``: whole PerMFL experiments of a paper model, as a
researcher runs them (``repro_torch.train.engine.run_experiment``:
``drive`` -> ``PerMFL.round`` -> ``core/permfl.py::permfl_round``, an eval
after every round).

Set-up makes the federation's data (``traffic/fl_images.py``) and the
initial weights (``reference/permfl_cnn.py::init_params``) from the
seed, builds the algorithm from the configuration's hyperparameters and
the mix's uplink, and runs the program's first rounds through the
window's own call: a 1-round and a ``check_rounds``-round experiment,
which also warm every kernel up. The window runs whole experiments of
the configuration's ``rounds`` back to back: ``fl_rounds_per_s`` is all
their rounds over all the window's time. The check runs the plain
reference (``reference/permfl_cnn.py``) from the same weights and data
and compares each round's train loss, each leaf's first gradient as the
prox step gets it, each tier's change after the first and the last
checked round (and, with compressed uplinks, the
error-feedback residuals and the link bytes).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import compare
from bench.reference import permfl_cnn as ref
from bench.traffic import fl_images

TIERS = ("x", "w", "theta")


def _nested(flat: dict) -> dict:
    """{"conv0.w": t} -> {"conv0": {"w": t}}."""
    out = {}
    for k, v in flat.items():
        layer, leaf = k.split(".")
        out.setdefault(layer, {})[leaf] = v
    return out


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _norms(tiers: dict, init: dict) -> dict:
    """{"tier/leaf": ||tier leaf - init leaf||} over every device or team
    of the tier, in float64."""
    out = {}
    for tier, leaves in tiers.items():
        for k, v in leaves.items():
            d = v.double() - init[k].double()
            out[f"{tier}/{k}"] = float(d.norm())
    return out


def _groups(keys) -> dict:
    return {k: k.split("/")[0] for k in keys}


class _Hooked:
    """The algorithm with ``on_round(t)`` called as its round t starts
    (the traced run)."""

    def __init__(self, algo, on_round):
        self._algo, self._on, self._t = algo, on_round, 0

    def __getattr__(self, name):
        return getattr(self._algo, name)

    def round(self, *args, **kw):
        self._on(self._t)
        self._t += 1
        return self._algo.round(*args, **kw)


class Path:
    def __init__(self, cell):
        self.cell, self.cfg, self.mix = cell, cell.config, cell.mix
        self.dev = torch.device(cell.device)
        self.check_seconds = 0.0
        self.setup_parts = {}

    # -- set-up ---------------------------------------------------------
    def inputs(self):
        """The federation's data on the host, from the seed."""
        self.host = fl_images.federation(self.cfg["federation"],
                                         self.cell.seed)

    def _on_device(self):
        to = lambda a: torch.from_numpy(a).to(self.dev)  # noqa: E731
        h = self.host
        return ({"x": to(h["train_x"]), "y": to(h["train_y"])},
                {"x": to(h["val_x"]), "y": to(h["val_y"])})

    def setup(self):
        from repro_torch.comm import CommConfig
        from repro_torch.configs.base import PaperModelConfig
        from repro_torch.core import PerMFL
        from repro_torch.core.permfl import PerMFLHParams
        from repro_torch.scenarios.spec import fns_for
        from repro_torch.train.engine import run_experiment

        # float32 products on the CUDA cores, as the configuration states
        torch.backends.cuda.matmul.allow_tf32 = self.cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = self.cfg["tf32"]
        model, fed = self.cfg["model"], self.cfg["federation"]
        t = time.perf_counter()
        self.inputs()
        train, val = self._on_device()
        init = ref.init_params(model, self.cell.seed, self.dev)
        _sync(self.dev)
        self.setup_parts["data and weights"] = time.perf_counter() - t
        pcfg = PaperModelConfig(
            name=self.cfg["name"], kind=model["kind"],
            input_shape=tuple(model["input_shape"]),
            num_classes=model["num_classes"],
            conv_channels=tuple(model["conv_channels"]),
            hidden=tuple(model["hidden"]))
        loss, metric = fns_for(pcfg)
        up = self.mix.get("uplink")
        comm = None if up is None else CommConfig(
            up["compressor"], k_frac=up["k_frac"],
            error_feedback=up["error_feedback"])
        self.algo = PerMFL(loss, PerMFLHParams(**self.cfg["algorithm"]),
                           comm=comm)
        params0 = _nested({k: v.clone() for k, v in init.items()})
        m, n = fed["m_teams"], fed["n_devices"]

        def experiment(rounds, algo=None, **kw):
            return run_experiment(algo or self.algo, params0, train, val,
                                  metric_fn=metric, rounds=rounds, m=m, n=n,
                                  seed=self.cell.seed, device=self.dev, **kw)

        self.experiment = experiment
        # the first gradient as the prox step gets it
        import repro_torch.core.permfl as permfl
        grads, spied = {}, permfl.device_grads

        def spy(loss_fn, layout, theta, batch):
            g = spied(loss_fn, layout, theta, batch)
            if not grads:
                grads.update({k: float(v.double().norm()) for k, v in
                              _flat(layout.unflatten(g)).items()})
            return g

        permfl.device_grads = spy
        t = time.perf_counter()
        try:
            first = experiment(1)
        finally:
            permfl.device_grads = spied
        last = experiment(self.mix["check_rounds"])
        self.setup_parts["first rounds"] = time.perf_counter() - t
        t = time.perf_counter()
        self.record = self._record(first, last, init)
        self.record["grad"] = grads
        self.check_seconds = time.perf_counter() - t

    def _record(self, first, last, init) -> dict:
        """What the check judges of the program's first rounds."""
        def tiers(state):
            return {t: _flat(state.params(t)) for t in TIERS}
        rec = {"loss": list(last.train_loss),
               "change1": _norms(tiers(first.state), init),
               "change": _norms(tiers(last.state), init)}
        if last.comm is not None:
            lay = last.state.layout
            zero = {k: torch.zeros_like(v) for k, v in init.items()}
            rec["ef"] = _norms(
                {"ef_dev": _flat(lay.unflatten(last.state.comm.ef_dev)),
                 "ef_team": _flat(lay.unflatten(last.state.comm.ef_team))},
                zero)
            s = last.comm.summary()
            rec["bytes"] = {k: s[f"{k}_bytes"] for k in
                            ("wan_up", "wan_down", "lan_up", "lan_down")}
        return rec

    # -- window ---------------------------------------------------------
    def _step(self, algo=None, **kw):
        res = self.experiment(self.cfg["rounds"], algo=algo, **kw)
        self._failed += sum(not np.isfinite(v) for v in res.train_loss)
        return res

    def window(self, seconds):
        from bench.core import closed_loop

        self._failed = 0

        def step():
            return {"rounds": len(self._step().round_seconds)}

        done, _, elapsed = closed_loop(step, seconds,
                                       lambda: _sync(self.dev))
        return ({"fl_rounds_per_s": done["rounds"] / elapsed},
                done["rounds"], self._failed)

    def traced(self, tracer):
        """A short experiment timed by parts (``time_parts``:
        synchronized around each part), then one whole experiment: from
        round ``trace_from`` ``trace_rounds`` rounds timed, then as many
        traced, their evals included."""
        self._failed = 0
        a, k = self.mix["trace_from"], self.mix["trace_rounds"]
        if a + 2 * k > self.cfg["rounds"]:
            raise ValueError(f"trace_from + 2 trace_rounds = {a + 2 * k} "
                             f"rounds > an experiment's {self.cfg['rounds']}")
        parts = self.experiment(k, time_parts=True).part_seconds

        def on_round(t):
            if t == a:
                tracer.plain()
            elif t == a + k:
                tracer.start()
            elif t == a + 2 * k:
                tracer.stop()

        res = self._step(algo=_Hooked(self.algo, on_round))
        tracer.data.steps = k
        tracer.data.extras["parts"] = parts
        return len(res.round_seconds), self._failed

    def release(self):
        self.experiment = self.algo = None
        _sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- check ----------------------------------------------------------
    def reference(self, control=False) -> dict:
        """The reference's record of the first rounds, from the seed's
        weights and the harness's data (``control``: its products in
        TF32, the precision below float32)."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = control
        torch.backends.cudnn.allow_tf32 = control
        try:
            return self._reference()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    def _reference(self) -> dict:
        model, fed = self.cfg["model"], self.cfg["federation"]
        m, n = fed["m_teams"], fed["n_devices"]
        train, _ = self._on_device()
        init = ref.init_params(model, self.cell.seed, self.dev)
        up = self.mix.get("uplink")
        k_frac = None if up is None else up["k_frac"]
        state = {"x": init,
                 "w": {k: v.expand((m,) + v.shape).clone()
                       for k, v in init.items()},
                 "theta": {k: v.expand((m, n) + v.shape).clone()
                           for k, v in init.items()}}
        if k_frac is not None:
            state["ef_dev"] = {k: torch.zeros((m, n) + v.shape,
                                              device=self.dev)
                               for k, v in init.items()}
            state["ef_team"] = {k: torch.zeros((m,) + v.shape,
                                               device=self.dev)
                                for k, v in init.items()}
        tx = train["x"].reshape((m * n,) + train["x"].shape[2:])
        ty = train["y"].reshape(m * n, -1)
        _, g0 = ref.grads({k: v.expand((m * n,) + v.shape)
                           for k, v in init.items()}, tx, ty)
        rec = {"grad": {k: float(v.double().norm()) for k, v in g0.items()},
               "loss": []}
        for r in range(self.mix["check_rounds"]):
            state = ref.permfl_round(state, train, self.cfg["algorithm"],
                                     k_frac)
            rec["loss"].append(ref.train_loss(state, train))
            if r == 0:
                rec["change1"] = _norms({t: state[t] for t in TIERS}, init)
        rec["change"] = _norms({t: state[t] for t in TIERS}, init)
        if k_frac is not None:
            zero = {k: torch.zeros_like(v) for k, v in init.items()}
            rec["ef"] = _norms({"ef_dev": state["ef_dev"],
                                "ef_team": state["ef_team"]}, zero)
            full, comp = ref.wire_bytes(ref.leaf_shapes(model), k_frac)
            r, k = self.mix["check_rounds"], self.cfg["algorithm"]["k_team"]
            rec["bytes"] = {"wan_up": r * m * comp, "wan_down": r * m * full,
                            "lan_up": r * k * m * n * comp,
                            "lan_down": r * k * m * n * full}
        return rec

    def compare(self, got: dict, want: dict) -> list:
        """The compared numbers of a record against the reference's."""
        limits = self.mix["limits"]
        keep = {f"{t}/{k}" for t in TIERS
                for k in compare.moved_leaves(want["grad"])}
        out = [compare.check("loss_gap", compare.worst_rel(
            got["loss"], want["loss"]), limits["loss_gap"])]
        # the median leaf: a ReLU or max-pool that switches on rounding
        # at the initial weights moves one unit's leaves by up to 2.5e-5
        # in sound float32 runs, as far as TF32 moves a leaf
        out.append(compare.check("grad_gap", compare.median_gap(
            got["grad"], want["grad"]), limits["grad_gap"],
            worst=compare.norm_gap(got["grad"], want["grad"])))
        for name in ("change1", "change"):
            gap, leaf = compare.norm_gap(got[name], want[name],
                                         _groups(want[name]), keep)
            out.append(compare.check(f"{name}_gap", gap,
                                     limits[f"{name}_gap"], leaf=leaf))
        if "ef" in want:
            gap, leaf = compare.norm_gap(got["ef"], want["ef"],
                                         _groups(want["ef"]))
            out.append(compare.check("ef_gap", gap, limits["ef_gap"],
                                     leaf=leaf))
            diff = max(abs(got["bytes"][k] - want["bytes"][k])
                       for k in want["bytes"])
            out.append(compare.check("bytes_gap", diff, limits["bytes_gap"]))
        return out

    def check(self) -> list:
        return self.compare(self.record, self.reference())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
