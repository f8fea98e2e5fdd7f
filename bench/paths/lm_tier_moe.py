"""Path ``lm_tier_moe``: ``lm_tier``'s protocol over a DeepSeekMoE
decoder (a dense lead, then fine-grained MoE layers): PerMFL's tier
rounds held on the card (``repro_torch.train.trainer.make_tier_round``
-> ``models/model.py::loss_fn`` -> ``transformer.stack_apply`` ->
``moe.moe_apply`` -> the fused router kernels and their backward).

Set-up, window, traced window and the comparison are ``lm_tier``'s
(``paths/lm_tier.py``). What differs: the program's configuration
carries the lead count and the MoE fields of the configuration file's
``model`` (``moe.group_size`` must be the program's group), the weights
and the check's reference are ``reference/deepseek_moe.py``'s, and the
first local step's routing is recorded on both sides at the routing seam
(``moe.route``): the check prints, for each MoE layer, the (token,
choice) pairs that chose an expert the reference did not, and the pairs
over capacity on each side. Those counts decide nothing: the compared
numbers are ``lm_tier``'s.
"""
from __future__ import annotations

import sys
import time

import torch

from bench.paths import lm_tier
from bench.paths.lm_tier import TIERS, _flat, _sync
from bench.reference import deepseek_moe as ref

# values a chunk of a leaf's change norm (512 MB in float64)
CHUNK = 1 << 26


class Path(lm_tier.Path):
    def program_config(self):
        """The program's ``ModelConfig`` of the file's ``model``."""
        from repro_torch.configs import MoEConfig, get_config
        from repro_torch.models import moe

        m, mo = self.model, self.model["moe"]
        if mo["group_size"] != moe.DEFAULT_GROUP:
            raise ValueError(f"group_size {mo['group_size']}: the program "
                             f"routes in groups of {moe.DEFAULT_GROUP}")
        return get_config(self.cfg["program_config"]).replace(
            **{k: m[k] for k in ("num_layers", "d_model", "num_heads",
                                 "num_kv_heads", "head_dim", "d_ff",
                                 "vocab_size", "rope_theta", "norm_eps",
                                 "tie_embeddings", "first_dense_layers")},
            moe=MoEConfig(num_experts=mo["num_experts"],
                          num_shared_experts=mo["num_shared_experts"],
                          top_k=mo["top_k"], expert_d_ff=mo["expert_d_ff"],
                          router_aux_weight=mo["aux_weight"],
                          capacity_factor=mo["capacity_factor"],
                          renormalize=mo["renormalize"]))

    def _changes(self, trees: dict) -> dict:
        """{"tier/leaf": ||leaf - its initial value||}, each initial leaf
        drawn again from the seed; the float64 sum of squares taken a
        chunk at a time, so that the experts' 1.1 G-value leaves need no
        float64 copy beside the reference's trees."""
        out = {}
        for name in ref.leaf_shapes(self.model):
            init = ref.init_leaf(self.model, self.cell.seed, name, self.dev,
                                 self.dtype).reshape(-1)
            for tier, tree in trees.items():
                sq = torch.zeros((), dtype=torch.float64, device=self.dev)
                for a, b in zip(tree[name].reshape(-1).split(CHUNK),
                                init.split(CHUNK)):
                    sq += (a.double() - b.double()).square().sum()
                out[f"{tier}/{name}"] = float(sq.sqrt())
            del init
        return out

    def setup(self):
        import repro_torch.models.moe as moe
        import repro_torch.train.trainer as trainer

        torch.backends.cuda.matmul.allow_tf32 = False
        mix = self.mix
        pcfg = self.program_config()
        t = time.perf_counter()
        self.inputs()
        tok, tgt = self.host_batches
        self.setup_parts["tokens"] = time.perf_counter() - t
        t = time.perf_counter()
        self.ring = [{"tokens": torch.from_numpy(a).to(self.dev),
                      "targets": torch.from_numpy(b).to(self.dev)}
                     for a, b in zip(tok, tgt)]
        params = ref.nest(ref.init_params(self.model, self.cell.seed,
                                          self.dev, self.dtype))
        _sync(self.dev)
        self.setup_parts["weights"] = time.perf_counter() - t
        t_rounds = time.perf_counter()
        self.round_fn = trainer.make_tier_round(pcfg, **mix["tier"])
        self.state = (params, params, params)
        self.rounds = 0
        self.losses = []

        # the first gradient as the prox step gets it, and the first
        # forward's routing
        grads, routes = {}, []
        spy_of, route_of = trainer.prox_sgd_tree, moe.route
        n_moe = sum(pcfg.moe_layer_mask())
        cap = moe._capacity(min(moe.DEFAULT_GROUP, mix["batch"]
                                * mix["seq_len"]), pcfg.moe.num_experts,
                            pcfg.moe.top_k, pcfg.moe.capacity_factor)

        def spy(theta, g, w, **kw):
            if not grads:
                grads.update({k: v.float().norm(dtype=torch.float64)
                              for k, v in _flat(g).items()})
            return spy_of(theta, g, w, **kw)

        def route_spy(xp, w, **kw):
            out = route_of(xp, w, **kw)
            if len(routes) < n_moe:
                routes.append((out[1].clone(), (out[2] >= cap).sum()))
            return out

        trainer.prox_sgd_tree, moe.route = spy, route_spy
        try:
            self._round()
        finally:
            trainer.prox_sgd_tree, moe.route = spy_of, route_of
        t = time.perf_counter()
        self.record = {"grad": {k: float(v) for k, v in grads.items()},
                       "routes": [(i, int(n)) for i, n in routes],
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

    # -- check ----------------------------------------------------------
    def reference(self, control=False) -> dict:
        """The reference's record of the first ``check_rounds`` rounds
        from the seed's weights on the ring's batches (``control``: its
        products' operands in float8, the precision below bfloat16)."""
        m = self.model
        quant = "fp8" if control else None
        tok, tgt = self.host_batches
        # no name holds the initial tree past the first round: _changes
        # draws each initial leaf again
        theta = w = x = ref.init_params(m, self.cell.seed, self.dev,
                                        self.dtype)
        rec = {"grad": {}, "loss": [], "routes": []}
        for r in range(self.mix["check_rounds"]):
            i = r % len(tok)
            theta, w, x, loss = ref.tier_round(
                theta, w, x, m, torch.from_numpy(tok[i]).to(self.dev),
                torch.from_numpy(tgt[i]).to(self.dev), self.mix["tier"],
                quant=quant, grad_norms=rec["grad"] if r == 0 else None,
                routes=rec["routes"] if r == 0 else None)
            rec["loss"].append(loss)
            if r == 0:
                rec["change1"] = self._changes({"theta": theta})
        rec["change"] = self._changes(dict(zip(TIERS, (theta, w, x))))
        return rec

    def check(self) -> list:
        with torch.no_grad():
            want = self.reference()
            print(routing_line(self.record["routes"], want["routes"],
                               self.model["moe"]["num_experts"]),
                  file=sys.stderr)
            return self.compare(self.record, want)


def routing_line(got: list, want: list, experts: int) -> str:
    """The first local step's routing, program against reference, a MoE
    layer each: the (token, choice) pairs whose expert the reference did
    not choose for that token, and the pairs over capacity on each
    side."""
    moved = []
    for (a, _), (b, _) in zip(got, want):
        if a.shape != b.shape:
            moved.append(None)
            continue
        sel = torch.zeros(a.shape[0], experts, dtype=torch.int8,
                          device=a.device)
        sel.scatter_(1, b.long(), 1)
        moved.append(int((sel.gather(1, a.long()) == 0).sum()))
    pairs = want[0][0].numel() if want else 0
    return (f"bench: routing of the first step, by MoE layer, of {pairs} "
            f"pairs: chosen by the program alone {moved}; over capacity, "
            f"program {[n for _, n in got]}, reference "
            f"{[n for _, n in want]}")
