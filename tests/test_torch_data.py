"""The port's numpy data layer and scenario specs against the JAX
package's: partitions bit-equal for the same seeds, every ported
scenario's ``to_dict()`` and ``spec_hash()`` equal, and the registry
refusing what it does not run yet."""
import contextlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)


def _assert_fd_equal(a, b):
    for f in ("train_x", "train_y", "val_x", "val_y"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("dataset", ["mnist", "fmnist"])
def test_make_dataset_and_label_skew_bit_equal(seed, dataset):
    from repro.data import federated as JF, synthetic as JS
    from repro_torch.data import federated as F, synthetic as S

    x_j, y_j = JS.make_dataset(dataset, np.random.default_rng(seed),
                               n_per_class=40)
    x_p, y_p = S.make_dataset(dataset, np.random.default_rng(seed),
                              n_per_class=40)
    assert np.array_equal(x_j, x_p) and np.array_equal(y_j, y_p)
    kw = dict(m_teams=3, n_devices=4, samples_per_device=16)
    with _quiet():
        fd_j = JF.partition_label_skew(np.random.default_rng(seed), x_j,
                                       y_j, **kw)
        fd_p = F.partition_label_skew(np.random.default_rng(seed), x_p,
                                      y_p, **kw)
    _assert_fd_equal(fd_j, fd_p)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_tabular_and_partition_bit_equal(seed):
    from repro.data import federated as JF, synthetic as JS
    from repro_torch.data import federated as F, synthetic as S

    devs_j = JS.synthetic_tabular(np.random.default_rng(seed), 12,
                                  min_samples=20, max_samples=60)
    devs_p = S.synthetic_tabular(np.random.default_rng(seed), 12,
                                 min_samples=20, max_samples=60)
    for (xj, yj), (xp, yp) in zip(devs_j, devs_p):
        assert np.array_equal(xj, xp) and np.array_equal(yj, yp)
    kw = dict(m_teams=4, n_devices=3, samples_per_device=32)
    _assert_fd_equal(JF.partition_tabular(devs_j, **kw),
                     F.partition_tabular(devs_p, **kw))


@pytest.mark.parametrize("partitioner", ["dirichlet", "quantity"])
def test_other_partitioners_bit_equal(partitioner):
    from repro.scenarios.spec import DataSpec as JDataSpec
    from repro_torch.scenarios.spec import DataSpec

    kw = dict(dataset="mnist", partitioner=partitioner, m_teams=2,
              n_devices=3, samples_per_device=16, n_per_class=30)
    with _quiet():
        _assert_fd_equal(JDataSpec(**kw).build(5), DataSpec(**kw).build(5))


def test_ported_scenarios_equal_the_reference():
    """Every ported name: the same spec dict and hash as the reference,
    and the same FederatedData for the registered size of one cell."""
    from repro.scenarios import SCENARIOS as J_SCENARIOS
    from repro_torch.scenarios import SCENARIOS, FLScenario

    assert len(SCENARIOS) == 95
    assert set(SCENARIOS) == set(J_SCENARIOS)
    for name, s in SCENARIOS.items():
        assert s.to_dict() == J_SCENARIOS[name].to_dict(), name
        assert s.spec_hash() == J_SCENARIOS[name].spec_hash(), name
        assert FLScenario.from_dict(s.to_dict()) == s
        assert s.algo.resolved() == J_SCENARIOS[name].algo.resolved()
        if s.algo.name == "permfl":
            assert s.algo.hparams() == _as_port_hp(J_SCENARIOS[name].algo
                                                   .hparams())
    s = SCENARIOS["fig2/fmnist/cnn/permfl"]
    assert (s.data.m_teams, s.data.n_devices,
            s.data.samples_per_device) == (4, 10, 48)
    _assert_fd_equal(s.data.build(s.data_seed),
                     J_SCENARIOS[s.name].data.build(s.data_seed))


def test_unported_scenarios_and_fields_are_refused():
    """The cohort_size and system fields cross from the reference's dict
    (both are ported); unknown names and algorithms are still refused."""
    from repro.scenarios import SCENARIOS as J_SCENARIOS
    from repro_torch.scenarios import AlgoSpec, FLScenario, get_scenario

    j = J_SCENARIOS["cohort/virtual/n1000"].with_system(
        "edge-iot").scaled(n_devices=50)
    s = FLScenario.from_dict(j.to_dict())
    assert s.to_dict() == j.to_dict() and s.spec_hash() == j.spec_hash()
    assert s.cohort_size == 50 and s.system.name == "edge-iot"
    assert get_scenario(j.to_dict()) == s
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("cohort/virtual/n5")
    with pytest.raises(ValueError, match="unknown algorithm"):
        AlgoSpec("fedprox")


def _as_port_hp(jhp):
    import dataclasses

    from repro_torch.core.permfl import PerMFLHParams
    return PerMFLHParams(**{f.name: getattr(jhp, f.name)
                            for f in dataclasses.fields(PerMFLHParams)})


@contextlib.contextmanager
def _quiet():
    """Silence the partitioners' pool-exhaustion warning (both packages
    warn alike; the arrays are what is compared)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield
