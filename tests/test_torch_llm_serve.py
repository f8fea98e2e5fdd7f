"""The port's LLM serving on the CPU: ``ServeEngine.generate`` against the
JAX ``ServeEngine`` with the same parameters and prompts (greedy tokens
equal), the samplers (``tests/test_serve.py``'s tests), the command line
``python -m repro_torch.serve.llm``, and the entry points' refusal to
run without a card unless asked for the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402


def _port(arch, vocab):
    from repro_torch.configs import get_reduced_config
    return get_reduced_config(arch).replace(vocab_size=vocab)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b"])
def test_engine_greedy_matches_jax(arch):
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve import ServeEngine

    jcfg = j_reduced(arch).replace(vocab_size=64)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    prompt = np.random.default_rng(1).integers(0, 64, (3, 8)) \
        .astype(np.int32)
    want = JServeEngine(cfg=jcfg, params=jparams, max_len=16).generate(
        {"tokens": jnp.asarray(prompt)}, max_new_tokens=6)
    eng = ServeEngine(cfg=_port(arch, 64),
                      params=params_from_numpy(jax.tree.map(np.asarray,
                                                            jparams)),
                      max_len=16, device="cpu")
    got = eng.generate({"tokens": prompt}, max_new_tokens=6)
    assert got.shape == (3, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_sampler():
    from repro_torch.serve.sampler import greedy

    logits = torch.zeros(2, 1, 8)
    logits[0, 0, 3] = 5.0
    logits[1, 0, 6] = 5.0
    toks = greedy(logits)
    assert toks.shape == (2, 1) and toks.dtype == torch.int32
    assert toks[0, 0] == 3 and toks[1, 0] == 6


def test_temperature_sampler_topk():
    from repro_torch.serve.sampler import temperature

    logits = torch.arange(8.0)[None, None, :]
    gen = torch.Generator().manual_seed(0)
    # with top_k=1 it must behave greedily regardless of temperature
    for _ in range(5):
        assert int(temperature(logits, gen, temp=10.0, top_k=1)[0, 0]) == 7


def test_temperature_sampler_follows_the_softmax():
    """Draw frequencies follow softmax(logits / temp) (4000 draws, 4
    sigma)."""
    from repro_torch.serve.sampler import temperature

    logits = torch.tensor([0.0, 1.0, 2.0, -1.0])
    gen = torch.Generator().manual_seed(3)
    draws = temperature(logits.expand(4000, 1, 4), gen, temp=1.5)[:, 0]
    freq = torch.bincount(draws.long(), minlength=4).float() / 4000
    p = torch.softmax(logits / 1.5, dim=0)
    assert bool(((freq - p).abs() <= 4 * (p * (1 - p) / 4000).sqrt()).all())


def test_engine_temperature_deterministic_per_seed():
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = _port("phi3-mini-3.8b", 32)
    params = M.init_params(4, cfg, device="cpu")
    eng = ServeEngine(cfg=cfg, params=params, max_len=16, sample="temp",
                      temp=1.0, device="cpu")
    prompt = {"tokens": torch.zeros(2, 4, dtype=torch.int32)}
    a = eng.generate(prompt, max_new_tokens=5, seed=7)
    b = eng.generate(prompt, max_new_tokens=5, seed=7)
    c = eng.generate(prompt, max_new_tokens=5, seed=8)
    assert torch.equal(a, b)
    assert a.shape == c.shape == (2, 5)


def test_engine_greedy_matches_stepwise_forward():
    """Engine greedy generation == argmax rollout via full forwards, with
    a bfloat16 model and cache."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = _port("qwen3-14b", 32)
    params = M.init_params(2, cfg, dtype=torch.bfloat16, device="cpu")
    toks = torch.randint(0, 32, (1, 6), generator=torch.Generator()
                         .manual_seed(3))
    eng = ServeEngine(cfg=cfg, params=params, max_len=16,
                      cache_dtype=torch.bfloat16, device="cpu")
    out = eng.generate({"tokens": toks}, max_new_tokens=4)
    seq = toks
    for i in range(4):
        logits, _ = M.forward(params, cfg, {"tokens": seq})
        nxt = logits[0, -1].argmax()
        assert int(out[0, i]) == int(nxt), (out, i)
        seq = torch.cat([seq, nxt.view(1, 1)], dim=1)


def test_engine_checks(monkeypatch):
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine, make_decode_step

    cfg = _port("phi3-mini-3.8b", 32)
    params = M.init_params(0, cfg, device="cpu")
    eng = ServeEngine(cfg=cfg, params=params, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate({"tokens": torch.zeros(1, 6, dtype=torch.int32)},
                     max_new_tokens=4)
    # a VLM's decode step puts the token at M-RoPE position (pos, pos,
    # pos): (b, 1, 3) int32 on the tokens' device
    seen = []
    real = M.decode_step

    def spy(params, cfg_, cache, batch, pos, **kw):
        seen.append((batch["mrope_positions"], pos))
        return real(params, cfg_, cache, batch, pos, **kw)

    vlm = _port("qwen2-vl-2b", 32)
    vparams = M.init_params(0, vlm, device="cpu")
    cache = M.init_cache(vlm, 3, 8, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(M, "decode_step", spy)
    tok, _ = make_decode_step(vlm)(
        vparams, cache, torch.zeros(3, 1, dtype=torch.int32), 5, None)
    (mp, pos), = seen
    assert pos == 5 and tok.shape == (3, 1)
    assert mp.shape == (3, 1, 3) and mp.dtype == torch.int32
    assert bool((mp == 5).all()) and mp.device == tok.device


def test_entry_points_ask_for_the_card():
    """Without ``device="cpu"`` the entry points run on the card, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.llm import main

    cfg = _port("phi3-mini-3.8b", 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 1, 4)
    params = M.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg=cfg, params=params, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "phi3-mini-3.8b", "--batch", "1", "--prompt-len",
              "2", "--new", "2"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-14b",
                                  "whisper-small", "qwen2-vl-2b"])
def test_cli_serves_on_the_cpu(arch, capsys):
    from repro_torch.serve.llm import main

    assert main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                 "--new", "4", "--sample", "temp", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "request 1:" in out
    assert "8 tokens in" in out and "(reduced model, CPU)" in out


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_cli_refuses_families_of_later_slices(arch, capsys):
    """Jamba, the last family a slice added: the CLI serves its reduced
    config on the CPU and names its cache as the reference's does."""
    from repro_torch.serve.llm import main

    assert main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                 "--new", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch} family=hybrid cache=hybrid" in out
    assert "request 1:" in out and "8 tokens in" in out
