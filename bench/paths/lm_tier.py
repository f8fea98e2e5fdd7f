"""Path ``lm_tier``: PerMFL's tier rounds at LLM scale, one team (one
device's view) held on the card (``repro_torch.train.trainer.
make_tier_round``: ``l_local`` x (forward, backward through the
attention kernels, ``prox_sgd_tree``), then eqs. 9 and 13).

Set-up draws theta = w = x from the seed on the card in the stored type
(``reference/phi3.py::init_leaf``, one generator a leaf), cuts a ring of
token batches from the seed (``traffic/lm_tokens.py``), and runs the
first ``check_rounds`` rounds through the window's own call on the
ring's first batches, reading what the check judges: each round's loss,
each leaf's first gradient as the prox step gets it, and each tier's
change; one more round lets the allocator settle after the readings. The window carries theta, w and x on through the ring:
``lm_tokens_per_s`` is l_local x batch x seq_len tokens a round over all
the window's time. The check runs the plain reference (``reference/
phi3.py``) from the seed's weights on the same batches.
"""
from __future__ import annotations

import math
import time

import torch

from bench import compare
from bench.reference import phi3 as ref
from bench.traffic import lm_tokens

TIERS = ("theta", "w", "x")
TYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class Path:
    def __init__(self, cell):
        self.cell, self.cfg, self.mix = cell, cell.config, cell.mix
        self.model = self.cfg["model"]
        self.dev = torch.device(cell.device)
        self.dtype = TYPES[self.cfg["precision"]]
        self.check_seconds = 0.0
        self.setup_parts = {}

    def _changes(self, trees: dict) -> dict:
        """{"tier/leaf": ||leaf - its initial value||} in float32, each
        initial leaf drawn again from the seed."""
        out = {}
        for name in ref.leaf_shapes(self.model):
            init = ref.init_leaf(self.model, self.cell.seed, name, self.dev,
                                 self.dtype).float()
            for tier, tree in trees.items():
                out[f"{tier}/{name}"] = float(
                    (tree[name].float() - init).norm(dtype=torch.float64))
            del init
        return out

    def inputs(self):
        """The ring of token batches on the host, from the seed."""
        m, mix = self.model, self.mix
        self.host_batches = lm_tokens.batches(
            self.cell.seed, m["vocab_size"], batch=mix["batch"],
            seq_len=mix["seq_len"], count=mix["ring"], topic=mix["topic"])

    def setup(self):
        import repro_torch.train.trainer as trainer
        from repro_torch.configs import get_config

        torch.backends.cuda.matmul.allow_tf32 = False
        m, mix = self.model, self.mix
        pcfg = get_config(self.cfg["program_config"]).replace(
            **{k: m[k] for k in ("num_layers", "d_model", "num_heads",
                                 "num_kv_heads", "head_dim", "d_ff",
                                 "vocab_size", "rope_theta", "norm_eps",
                                 "tie_embeddings")})
        t = time.perf_counter()
        self.inputs()
        tok, tgt = self.host_batches
        self.setup_parts["tokens"] = time.perf_counter() - t
        t = time.perf_counter()
        self.ring = [{"tokens": torch.from_numpy(a).to(self.dev),
                      "targets": torch.from_numpy(b).to(self.dev)}
                     for a, b in zip(tok, tgt)]
        params = ref.nest(ref.init_params(m, self.cell.seed, self.dev,
                                          self.dtype))
        _sync(self.dev)
        self.setup_parts["weights"] = time.perf_counter() - t
        t_rounds = time.perf_counter()
        self.round_fn = trainer.make_tier_round(pcfg, **mix["tier"])
        self.state = (params, params, params)
        self.rounds = 0
        self.losses = []

        # the first gradient as the prox step gets it
        grads = {}
        spy_of = trainer.prox_sgd_tree

        def spy(theta, g, w, **kw):
            if not grads:
                grads.update({k: v.float().norm(dtype=torch.float64)
                              for k, v in _flat(g).items()})
            return spy_of(theta, g, w, **kw)

        trainer.prox_sgd_tree = spy
        try:
            self._round()
        finally:
            trainer.prox_sgd_tree = spy_of
        t = time.perf_counter()
        self.record = {"grad": {k: float(v) for k, v in grads.items()},
                       "change1": self._changes(
                           {"theta": _flat(self.state[0])})}
        self.check_seconds += time.perf_counter() - t
        for _ in range(1, mix["check_rounds"]):
            self._round()
        t = time.perf_counter()
        self.record["loss"] = [float(v) for v in self.losses]
        self.record["change"] = self._changes(
            dict(zip(TIERS, (_flat(s) for s in self.state))))
        self.check_seconds += time.perf_counter() - t
        # one more round settles the allocator after the readings' temps
        self._round()
        _sync(self.dev)
        self.setup_parts["first rounds"] = time.perf_counter() - t_rounds \
            - self.check_seconds
    def _round(self):
        batch = self.ring[self.rounds % len(self.ring)]
        theta, w, x, met = self.round_fn(*self.state, batch)
        self.state = (theta, w, x)
        self.losses.append(met["loss"])
        self.rounds += 1
        mix = self.mix
        return {"tokens": mix["tier"]["l_local"] * mix["batch"]
                * mix["seq_len"]}

    def _failed(self, start) -> int:
        vals = torch.stack(self.losses[start:]).tolist()
        return sum(not math.isfinite(v) for v in vals)

    def window(self, seconds):
        from bench.core import closed_loop

        start = len(self.losses)
        done, steps, elapsed = closed_loop(self._round, seconds,
                                           lambda: _sync(self.dev))
        return ({"lm_tokens_per_s": done["tokens"] / elapsed}, steps,
                self._failed(start))

    def traced(self, tracer):
        start, k = len(self.losses), self.mix["trace_rounds"]
        tracer.plain()
        for _ in range(k):
            self._round()
        tracer.start()
        for _ in range(k):
            self._round()
        tracer.stop()
        tracer.data.steps = k
        return 2 * k, self._failed(start)

    def release(self):
        self.state = self.ring = self.round_fn = None
        _sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- check ----------------------------------------------------------
    def reference(self, control=False) -> dict:
        """The reference's record of the first ``check_rounds`` rounds
        from the seed's weights on the ring's batches (``control``: its
        products' operands in float8, the precision below bfloat16)."""
        m = self.model
        quant = "fp8" if control else None
        tok, tgt = self.host_batches
        init = ref.init_params(m, self.cell.seed, self.dev, self.dtype)
        theta = w = x = init
        rec = {"grad": {}, "loss": []}
        for r in range(self.mix["check_rounds"]):
            i = r % len(tok)
            theta, w, x, loss = ref.tier_round(
                theta, w, x, m, torch.from_numpy(tok[i]).to(self.dev),
                torch.from_numpy(tgt[i]).to(self.dev), self.mix["tier"],
                quant=quant, grad_norms=rec["grad"] if r == 0 else None)
            rec["loss"].append(loss)
            if r == 0:
                rec["change1"] = self._changes({"theta": theta})
        rec["change"] = self._changes(dict(zip(TIERS, (theta, w, x))))
        return rec

    def compare(self, got: dict, want: dict) -> list:
        limits = self.mix["limits"]
        keep = compare.moved_leaves(want["grad"])
        out = [compare.check("loss_gap", compare.worst_rel(
            got["loss"], want["loss"]), limits["loss_gap"])]
        gap, leaf = compare.norm_gap(got["grad"], want["grad"])
        out.append(compare.check("grad_gap", gap, limits["grad_gap"],
                                 leaf=leaf))
        for name in ("change1", "change"):
            if f"{name}_gap" not in limits:
                continue
            k = {f"{t}/{leaf}" for t in TIERS for leaf in keep}
            groups = {key: key.split("/")[0] for key in want[name]}
            gap, leaf = compare.norm_gap(got[name], want[name], groups, k)
            out.append(compare.check(f"{name}_gap", gap,
                                     limits[f"{name}_gap"], leaf=leaf))
        return out

    def check(self) -> list:
        with torch.no_grad():
            return self.compare(self.record, self.reference())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
