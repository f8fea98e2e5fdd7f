"""The port's example scripts (``examples/*_torch.py``) on the CPU, held
against the reference's scripts and the functions they call.

- ``quickstart_torch.py``: at 3 rounds, each of its four runs against the
  reference's ``run_scenario`` of the same cell and rounds: PM/TM/GM and
  the train loss a round within rtol 1e-4 / atol 1e-4 (the rounds'
  tolerance of ROADMAP.md queue 3), every field of ``comm.summary()``
  exactly, and the two wan-cellular runs, fed the reference's link
  draws, their simulated seconds within rtol 1e-6 (``tests/
  test_torch_system.py``'s time tolerance); top-10% takes fewer simulated
  seconds than fp32 in both packages.
- ``federated_benchmark_torch.py``: ``--dump-spec`` prints the
  reference's JSON, with an equal ``spec_hash``; ``--theory-hparams`` the
  reference's hyperparameters within 1e-6 relative, and the CSV's curves
  within the rounds' tolerance.
- ``serve_model_torch.py``: the cache-family line equal to the
  reference script's, and the greedy tokens of its generation
  (``repro_torch.serve.llm.timed_generate``) from the reference's params
  and prompt equal to the tokens the reference script printed (dense, MoE, RWKV-6, Whisper and
  Qwen2-VL, reduced); ``--personalized``: each request's tier and class,
  and the device tier's bytes, equal to the reference's ``ModelStore``,
  ``serving_params`` and ``paper_models.apply``.
- The examples import no ``jax`` and no ``repro`` module, and each raises
  without a card unless ``--device cpu`` is given.
"""
import ast
import contextlib
import csv
import importlib.util
import io
import json
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import system as JS  # noqa: E402
from repro.scenarios import SCENARIOS as J_SCENARIOS  # noqa: E402
from repro.scenarios import FLScenario as JFLScenario  # noqa: E402
from repro.scenarios import build_scenario as j_build  # noqa: E402
from repro.scenarios import run_scenario as j_run  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
PORTED = ("quickstart", "federated_benchmark", "serve_model",
          "tiered_llm_training")
TOL = dict(rtol=1e-4, atol=1e-4)
TIME_RTOL = 1e-6
ROUNDS = 3


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _close_curves(got, want):
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   err_msg=f, **TOL)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def _reference_links(name, profile, rounds, seed=0):
    """The reference engine's links of a full-participation run: the
    system stream split off the carried key each round."""
    b = j_build(J_SCENARIOS[name], seed)
    leaves = JS.get_profile(profile).tree_floats()[0]
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, skey = jax.random.split(key)
        out.append([np.asarray(a) for a in
                    JS.sample_links(leaves, skey, b.m, b.n)])
    return out


def test_quickstart_matches_the_reference_runs():
    mod = _load("quickstart_torch")
    links = _reference_links("comm/mnist/mclr/uncompressed", "wan-cellular",
                             ROUNDS)
    (res, res_c, t_full, t_comp), out = _stdout(
        mod.quickstart, rounds=ROUNDS, device="cpu",
        links=links.__getitem__)
    want = {
        "plain": j_run(J_SCENARIOS["table1/mnist/mclr/permfl"],
                       rounds=ROUNDS),
        "topk": j_run(J_SCENARIOS["comm/mnist/mclr/topk_10"],
                      rounds=ROUNDS),
        "full_sys": j_run(J_SCENARIOS["comm/mnist/mclr/uncompressed"],
                          rounds=ROUNDS, system="wan-cellular"),
        "topk_sys": j_run(J_SCENARIOS["comm/mnist/mclr/topk_10"],
                          rounds=ROUNDS, system="wan-cellular")}
    got = {"plain": res, "topk": res_c, "full_sys": t_full,
           "topk_sys": t_comp}
    for key, r in got.items():
        _close_curves(r, want[key])
    for key in ("topk", "topk_sys"):
        assert got[key].comm.summary() == want[key].comm.summary(), key
    assert res.comm is None and t_full.comm is None
    for key in ("full_sys", "topk_sys"):
        np.testing.assert_allclose(got[key].timeline.round_seconds,
                                   want[key].timeline.round_seconds,
                                   rtol=TIME_RTOL, err_msg=key)
        np.testing.assert_allclose(got[key].sim_seconds,
                                   want[key].sim_seconds, rtol=TIME_RTOL)
    for runs in (got, want):
        assert (runs["topk_sys"].timeline.total_seconds()
                < runs["full_sys"].timeline.total_seconds())
    assert f"round  {ROUNDS - 1}: PM=" in out
    assert "MB at fp32 (uplink shrunk" in out
    assert "time-to-accuracy curve tail" in out


# ---------------------------------------------------------------------------
# federated_benchmark
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["--partitioner", "dirichlet", "--alpha", "0.3", "--formation",
         "worst"]])
def test_federated_benchmark_dump_spec_is_the_reference(argv):
    from repro_torch.scenarios import FLScenario

    _, got = _stdout(_load("federated_benchmark_torch").main,
                     argv + ["--dump-spec"])
    _, want = _stdout(_load("federated_benchmark").main,
                      argv + ["--dump-spec"])
    assert got == want
    d = json.loads(got)
    assert (FLScenario.from_dict(d).spec_hash()
            == JFLScenario.from_dict(d).spec_hash())


def _theory(out):
    line = next(ln for ln in out.splitlines()
                if ln.startswith("theory hparams: "))
    return ast.literal_eval(line[len("theory hparams: "):])


def _curves(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], np.float64)


def test_federated_benchmark_theory_hparams_and_curves(tmp_path):
    argv = ["--dataset", "mnist", "--model", "mclr", "--rounds",
            str(ROUNDS), "--theory-hparams"]
    _, got = _stdout(_load("federated_benchmark_torch").main,
                     argv + ["--out", str(tmp_path / "port.csv"),
                             "--device", "cpu"])
    _, want = _stdout(_load("federated_benchmark").main,
                      argv + ["--out", str(tmp_path / "ref.csv")])
    th, jth = _theory(got), _theory(want)
    assert th.keys() == jth.keys()
    for k in th:
        np.testing.assert_allclose(th[k], jth[k], rtol=1e-6, err_msg=k)
    head, curves = _curves(tmp_path / "port.csv")
    jhead, jcurves = _curves(tmp_path / "ref.csv")
    assert head == jhead and curves.shape == (ROUNDS, 5)
    np.testing.assert_allclose(curves, jcurves, **TOL)
    assert "final: PerMFL(PM)" in got.splitlines()[-1]


# ---------------------------------------------------------------------------
# serve_model
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--batch", "2", "--prompt-len", "8", "--new", "4"]


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-moe-16b",
                                  "rwkv6-7b", "whisper-small",
                                  "qwen2-vl-2b"])
def test_serve_model_tokens_match_the_reference_script(arch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve.llm import VOCAB, timed_generate

    ref = _load("serve_model")
    seen = {}

    class Recording(ref.ServeEngine):
        """The reference script's engine, keeping its params and prompt."""

        def generate(self, batch, **kw):
            seen.update(cfg=self.cfg, params=self.params, prompt=batch)
            return super().generate(batch, **kw)

    ref.ServeEngine = Recording
    _, want = _stdout(ref.main, ["--arch", arch] + SERVE_ARGS)
    _, got = _stdout(_load("serve_model_torch").main,
                     ["--arch", arch, "--device", "cpu"] + SERVE_ARGS)
    assert got.splitlines()[0] == want.splitlines()[0]
    rows = [ast.literal_eval(ln.split(": ", 1)[1])
            for ln in want.splitlines() if ln.startswith("  request ")]

    cfg = get_reduced_config(arch).replace(vocab_size=VOCAB)
    params = params_from_numpy(jax.tree.map(np.asarray, seen["params"]))
    prompt = {k: torch.from_numpy(np.asarray(v))
              for k, v in seen["prompt"].items()}
    toks, sec = timed_generate(cfg, params, prompt, new=4, device="cpu")
    assert toks.dtype == torch.int32 and sec > 0
    assert toks.tolist() == rows


def test_serve_model_personalized_matches_the_reference_store(tmp_path):
    from repro.models import paper_models as JPM
    from repro.serve import ModelStore as JModelStore

    mod = _load("serve_model_torch")
    (rows, nbytes), out = _stdout(mod.personalized_demo,
                                  path=str(tmp_path / "store.zip"),
                                  device="cpu")
    s = J_SCENARIOS["table1/mnist/mclr/permfl"].scaled(
        m_teams=2, n_devices=3, samples_per_device=16, rounds=2)
    jres, jb = j_run(s, seed=0), j_build(s, seed=0)
    jstore = JModelStore.from_result(jb.algo, jres, m=jb.m, n=jb.n)
    assert nbytes == jstore.device_tier_nbytes()
    xv = np.asarray(jb.val["x"], np.float32)
    xs = xv.reshape((-1,) + xv.shape[3:])[:4]
    want = []
    for t, d, x in zip(mod.TEAMS, mod.DEVICES, xs):
        tiers = jstore.resolve_tiers(np.array([t]), np.array([d]))
        tier = next(k for k, v in tiers.items() if int(v) == 1)
        p = (jb.algo.serving_params(jres.state, int(t), int(d))
             if tier == "device" else
             jb.algo.serving_params(jres.state, int(t))
             if tier == "team" else jb.algo.serving_params(jres.state))
        cls = int(np.argmax(np.asarray(JPM.apply(p, jb.config, x[None])[0])))
        want.append((int(t), int(d), tier, cls))
    assert rows == want
    assert [r[2] for r in rows] == ["device", "device", "team", "global"]
    assert out.count("-tier model, class ") == 4


# ---------------------------------------------------------------------------
# imports and the card
# ---------------------------------------------------------------------------

def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("name", PORTED)
def test_examples_import_no_jax_and_no_reference(name):
    names = _imported(EXAMPLES / f"{name}_torch.py")
    assert any(n.startswith("repro_torch.") for n in names)
    bad = {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, bad


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", []),
    ("federated_benchmark_torch", ["--rounds", "1"]),
    ("serve_model_torch", []),
    ("serve_model_torch", ["--personalized"])])
def test_examples_raise_without_a_card(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _stdout(_load(name).main, argv)
