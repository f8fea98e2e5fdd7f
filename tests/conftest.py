"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the 1 real CPU
device; only launch/dryrun.py (its own process) forces 512 host devices."""
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_fed_data():
    """4 teams x 3 devices of label-skewed synthetic-MNIST, tiny."""
    from repro.data.federated import partition_label_skew
    from repro.data.synthetic import make_dataset

    rng = np.random.default_rng(7)
    x, y = make_dataset("mnist", rng, n_per_class=60)
    return partition_label_skew(rng, x, y, m_teams=4, n_devices=3,
                                samples_per_device=32)


@pytest.fixture(scope="session")
def tabular_fed_data():
    from repro.data.federated import partition_tabular
    from repro.data.synthetic import synthetic_tabular

    rng = np.random.default_rng(11)
    devices = synthetic_tabular(rng, 12, min_samples=40, max_samples=80)
    return partition_tabular(devices, m_teams=4, n_devices=3,
                             samples_per_device=32)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (skips without one)")
