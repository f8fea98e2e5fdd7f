"""DeepSeekMoE's structure in the port, on the CPU: leading dense layers
before the periodic blocks (``ModelConfig.first_dense_layers``), the
top-k gates left unrenormalised (``MoEConfig.renormalize``), the MoE
layer's spans, and serving through a lead. Every registered
configuration keeps the JAX package's tree.

The small cut: 1 dense + 2 MoE layers, d 64, 4 heads of 16, 8 experts of
width 32, top-2, 2 shared, dense width 160, vocabulary 256, float32.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402


def _small(renormalize=False, capacity_factor=1.25, **kw):
    from repro_torch.configs import MoEConfig, get_config

    return get_config("deepseek-moe-16b").replace(
        num_layers=3, first_dense_layers=1, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=160, vocab_size=256,
        moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2,
                      expert_d_ff=32, router_aux_weight=0.001,
                      capacity_factor=capacity_factor,
                      renormalize=renormalize), **kw)


def _spec(tree, prefix=""):
    """[(path, shape, dtype)] of a port tree of tensors."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec(tree[k],
                                                       f"{prefix}/{k}")]
    return [(prefix.lstrip("/"), tuple(tree.shape),
             str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registered_trees_are_the_jax_packages(arch):
    """No lead by default: each registered configuration's tree at
    published widths is the JAX package's, leaf for leaf."""
    import jax.numpy as jnp

    from repro.configs import get_config as j_config
    from repro.models import model as JM
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    assert cfg.first_dense_layers == 0 and cfg.moe.renormalize
    want = sorted(("/".join(str(getattr(p, "key", p)) for p in path),
                   tuple(v.shape), str(v.dtype))
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      JM.param_specs(j_config(arch), dtype=jnp.bfloat16))[0])
    assert _spec(M.param_specs(cfg)) == want


def test_a_lead_comes_before_the_periodic_blocks():
    """The lead's layers are dense and stacked apart; the blocks' pattern
    is read from the layers after it (a MoE layer every second layer
    after a dense lead is periodic; without the lead's own entry it was
    not)."""
    from repro_torch.models import transformer as T

    cfg = _small()
    assert cfg.moe_layer_mask() == [False, True, True]
    assert T.lead_pattern(cfg) == (1, "attn")
    assert T.block_pattern(cfg) == (2, [("attn", True)])
    alt = cfg.replace(num_layers=5, moe_layer_period=2)
    assert alt.moe_layer_mask() == [False, True, False, True, False]
    assert T.block_pattern(alt) == (2, [("attn", True), ("attn", False)])
    assert T.block_pattern(alt.replace(first_dense_layers=0))[0] == 1
    assert T.lead_pattern(cfg.replace(first_dense_layers=0)) == (0, None)
    with pytest.raises(ValueError):
        T.lead_pattern(cfg.replace(first_dense_layers=3))


def test_the_lead_has_its_own_entry_in_the_tree():
    from repro_torch.flat import tree_leaves
    from repro_torch.models import model as M

    cfg = _small()
    params = M.init_params(0, cfg, device="cpu")
    blocks = params["blocks"]
    assert sorted(blocks) == ["lead", "pos0"]
    assert sorted(blocks["lead"]) == ["attn", "mlp", "norm1", "norm2"]
    assert tuple(blocks["lead"]["mlp"]["w_gate"].shape) == (1, 64, 160)
    assert tuple(blocks["pos0"]["moe"]["experts"]["w_gate"].shape) == \
        (2, 8, 64, 32)
    assert blocks["pos0"]["moe"]["router"].dtype == torch.float32
    assert len(tree_leaves(params)) == 25
    cache = M.init_cache(cfg, 2, 16, device="cpu")["layers"]
    assert tuple(cache["lead"]["k"].shape)[:2] == (1, 2)
    assert tuple(cache["pos0"]["k"].shape)[:2] == (2, 2)


@pytest.mark.parametrize("renormalize", [False, True])
def test_route_gates_are_renormalised_only_when_asked(renormalize):
    """The routing seam's plain steps: the gates are the chosen experts'
    softmax probabilities, divided by their sum only with
    ``renormalize``."""
    from repro_torch.models.moe import route

    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(32, 64, generator=g), torch.randn(64, 8, generator=g)
    gates, idx, _, _ = route(x, w, top_k=2, group_size=32,
                             renormalize=renormalize)
    probs = torch.softmax(x @ w, -1).gather(1, idx.long())
    want = probs / probs.sum(1, keepdim=True) if renormalize else probs
    torch.testing.assert_close(gates, want, rtol=1e-6, atol=1e-7)


def test_prefill_then_decode_matches_the_full_forward():
    """The small cut served: a prefill of 8 tokens, then 4 decode steps
    through the cache (the lead's included), give the full forward's
    logits within 1e-4 (float32, other sums). The capacity is set so no
    pair is dropped: which pairs a capacity drops depends on the group a
    token is routed in, and a decode step's group is its own batch."""
    from repro_torch.models import model as M

    cfg = _small(capacity_factor=8.0)
    params = M.init_params(1, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 256,
                                                             (2, 12)))
    full, _ = M.forward(params, cfg, {"tokens": toks})
    cache = M.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    logits, cache = M.prefill(params, cfg, {"tokens": toks[:, :8]}, cache)
    steps = [logits]
    for p in range(8, 12):
        out, cache = M.decode_step(params, cfg, cache,
                                   {"tokens": toks[:, p:p + 1]}, p)
        steps.append(out)
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=1e-4,
                               atol=1e-4)


def test_moe_spans_record_only_under_a_log(monkeypatch):
    """Under a log each MoE layer records ``moe`` over ``route``,
    ``dispatch``, ``experts``, ``combine`` and ``shared``, with its
    (token, choice) pairs and those over capacity (as the routing seam's
    positions count them); the lead's SwiGLU records ``dense_ffn``.
    Without a log nothing is recorded and the output is the same, bit for
    bit."""
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.obs.spans import SpanLog, current_log

    cfg = _small(capacity_factor=0.5)
    params = M.init_params(4, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, 256,
                                                             (2, 16)))
    plain, _ = M.forward(params, cfg, {"tokens": toks})
    assert current_log() is None
    over, route = [], moe.route

    def spy(*a, **kw):
        out = route(*a, **kw)
        over.append(int((out[2] >= moe._capacity(32, 8, 2, 0.5)).sum()))
        return out

    monkeypatch.setattr(moe, "route", spy)
    log = SpanLog()
    with log.activate():
        traced, _ = M.forward(params, cfg, {"tokens": toks})
    assert torch.equal(plain, traced)
    spans = [sp for sp in log.spans if sp.name == "moe"]
    assert [sp.path for sp in spans] == ["blocks/moe"] * 2
    assert [sp.name for sp in log.spans if sp.parent is spans[0]] == \
        ["route", "dispatch", "experts", "combine", "shared"]
    assert [sp.path for sp in log.spans if sp.name == "dense_ffn"] == \
        ["blocks/dense_ffn"]
    assert [sp.attrs["pairs"] for sp in spans] == [64, 64]
    assert [int(sp.attrs["dropped"]) for sp in spans] == over
    assert all(n > 0 for n in over)
