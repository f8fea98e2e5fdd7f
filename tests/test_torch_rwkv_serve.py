"""The port's RWKV-6 serving on the CPU: ``ServeEngine.generate`` of the
reduced ``rwkv6-7b`` against the JAX ``ServeEngine`` with the same
parameters and prompts (greedy tokens equal), a bf16 model with a bf16
cache as the card serves it, and the command line ``python -m
repro_torch.serve.llm --arch rwkv6-7b`` with the reference's cache label
(``examples/serve_model.py``: ``recurrent-state`` for ssm, ``hybrid``
for hybrid, ``kv`` otherwise)."""
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

ARCH = "rwkv6-7b"


def _port_cfg(vocab):
    from repro_torch.configs import get_reduced_config
    return get_reduced_config(ARCH).replace(vocab_size=vocab)


@pytest.mark.parametrize("prompt_len,new", [(8, 6), (1, 4)])
def test_engine_greedy_matches_jax(prompt_len, new):
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve import ServeEngine

    jcfg = j_reduced(ARCH).replace(vocab_size=64)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    prompt = np.random.default_rng(prompt_len).integers(
        0, 64, (3, prompt_len)).astype(np.int32)
    max_len = prompt_len + new
    want = JServeEngine(cfg=jcfg, params=jparams, max_len=max_len).generate(
        {"tokens": jnp.asarray(prompt)}, max_new_tokens=new)
    eng = ServeEngine(cfg=_port_cfg(64),
                      params=params_from_numpy(jax.tree.map(np.asarray,
                                                            jparams)),
                      max_len=max_len, device="cpu")
    got = eng.generate({"tokens": prompt}, max_new_tokens=new)
    assert got.shape == (3, new) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_bf16_with_bf16_cache():
    """The card's configuration: bf16 weights (float32 decay_w0 and
    bonus_u), a bf16 cache whose WKV state stays float32; tokens in
    range and equal to the plain path's (the same path on the CPU)."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = _port_cfg(128)
    params = M.init_params(3, cfg, dtype=torch.bfloat16, device="cpu")
    cache = M.init_cache(cfg, 2, 12, dtype=torch.bfloat16, device="cpu")
    assert cache["layers"]["pos0"]["tm_last"].dtype == torch.bfloat16
    assert cache["layers"]["pos0"]["wkv"].dtype == torch.float32
    prompt = torch.randint(0, 128, (2, 8),
                           generator=torch.Generator().manual_seed(4))
    kw = dict(cfg=cfg, params=params, max_len=12,
              cache_dtype=torch.bfloat16, device="cpu")
    out = ServeEngine(**kw).generate({"tokens": prompt}, max_new_tokens=5)
    again = ServeEngine(mode="torch", **kw).generate({"tokens": prompt},
                                                     max_new_tokens=5)
    assert out.shape == (2, 5) and bool(((out >= 0) & (out < 128)).all())
    assert torch.equal(out, again)


def test_cli_serves_rwkv_on_the_cpu(capsys):
    from repro_torch.serve.llm import main

    assert main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8",
                 "--new", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} family=ssm cache=recurrent-state" in out
    assert "request 1:" in out and "8 tokens in" in out


@pytest.mark.parametrize("arch,label", [
    ("rwkv6-7b", "recurrent-state"), ("jamba-1.5-large-398b", "hybrid"),
    ("deepseek-moe-16b", "kv"), ("qwen2-vl-2b", "kv"),
    ("whisper-small", "kv")])
def test_cache_label_follows_the_reference(arch, label):
    from repro_torch.configs import get_reduced_config
    from repro_torch.serve.llm import cache_kind

    fam = j_reduced(arch).family
    want = ("recurrent-state" if fam == "ssm" else
            "hybrid" if fam == "hybrid" else "kv")
    assert cache_kind(get_reduced_config(arch)) == want == label
