"""Synthetic datasets.

``synthetic_tabular`` reproduces the paper's Synthetic dataset exactly as
specified (§D.2.6 / Li et al. [36] "Federated optimization in heterogeneous
networks"): 60 features, 10 classes, per-device model heterogeneity
controlled by alpha-bar and data heterogeneity by beta-bar (both 0.5 in the
paper), device sample sizes drawn from a power law.

``synthetic_images`` stands in for MNIST/FMNIST/EMNIST in this offline
container: class-conditional 28x28 images (a class-specific low-rank
template + noise) with the same shapes, class counts, and separability
ordering; the paper's numbers are quoted alongside for qualitative
comparison (DESIGN.md §2).

``virtual_tabular`` is the cohort-scale variant of the feature-shift
construction: fully vectorized (no per-device Python loop) so the
virtualized cohort engine's 10^4-10^6 devices-per-team scenarios
(DESIGN.md §11) can materialize their populations in milliseconds.
"""
from __future__ import annotations

import numpy as np


def synthetic_tabular(rng: np.random.Generator, n_devices: int, *,
                      alpha: float = 0.5, beta: float = 0.5,
                      dim: int = 60, num_classes: int = 10,
                      min_samples: int = 250, max_samples: int = 25_810):
    """Returns list of (x (S,60) f32, y (S,) i32) per device."""
    # power-law sample sizes (Li et al. use lognormal; power law per §D.2.6)
    sizes = (np.random.default_rng(rng.integers(1 << 31))
             .pareto(1.2, n_devices) + 1)
    sizes = sizes / sizes.max()
    sizes = (min_samples + sizes * (max_samples - min_samples)).astype(int)
    sizes = np.clip(sizes, min_samples, max_samples)

    # global feature covariance: diag(j^-1.2)
    cov_diag = np.arange(1, dim + 1, dtype=np.float64) ** -1.2
    devices = []
    for i in range(n_devices):
        b_i = rng.normal(0, alpha)            # model heterogeneity
        u_i = rng.normal(0, beta)             # data heterogeneity
        v_i = rng.normal(u_i, 1.0, dim)       # device feature mean
        w_i = rng.normal(b_i, 1.0, (dim, num_classes))
        c_i = rng.normal(b_i, 1.0, num_classes)
        x = rng.normal(v_i, np.sqrt(cov_diag), (sizes[i], dim))
        logits = x @ w_i + c_i
        y = np.argmax(logits, axis=1)
        devices.append((x.astype(np.float32), y.astype(np.int32)))
    return devices


def feature_shift_tabular(rng: np.random.Generator, m_teams: int,
                          n_devices: int, *, dim: int = 60,
                          num_classes: int = 10, shift: float = 2.0,
                          samples_per_device: int = 64):
    """Feature-shift (covariate-shift) tabular devices: one *shared*
    labeling concept, team-specific feature distributions.

    A single global linear model labels every sample, so P(y|x) is
    identical across the federation; each team draws its features around
    a team-specific mean offset of magnitude ``shift`` (devices jitter
    slightly around their team's mean). Larger ``shift`` pushes teams
    into disjoint regions of feature space — the regime where per-team /
    per-device personalization pays even though the concept is shared
    (cf. the shared/personal split of Distributed Personalized Empirical
    Risk Minimization).

    Returns a team-major list of ``m_teams * n_devices`` devices, each
    ``(x (S, dim) f32, y (S,) i32)`` — stack with ``partition_tabular``.
    """
    w = rng.normal(0, 1, (dim, num_classes))
    c = rng.normal(0, 1, num_classes)
    cov_diag = np.arange(1, dim + 1, dtype=np.float64) ** -1.2
    devices = []
    for _ in range(m_teams):
        mu_team = rng.normal(0, shift, dim)       # team feature shift
        for _ in range(n_devices):
            v = mu_team + rng.normal(0, 0.1, dim)  # small device jitter
            x = rng.normal(v, np.sqrt(cov_diag), (samples_per_device, dim))
            y = np.argmax(x @ w + c, axis=1)
            devices.append((x.astype(np.float32), y.astype(np.int32)))
    return devices


def virtual_tabular(rng: np.random.Generator, m_teams: int,
                    n_devices: int, *, dim: int = 60,
                    num_classes: int = 10, shift: float = 2.0,
                    samples_per_device: int = 8):
    """Cohort-scale feature-shift tabular federation, fully vectorized.

    Same construction as ``feature_shift_tabular`` — one shared labeling
    concept, team-shifted feature means, small per-device jitter — but
    every tier is drawn in a handful of broadcasted numpy calls instead
    of a per-device Python loop, so materializing the 10^4-10^6 devices
    per team the virtualized cohort engine targets (DESIGN.md §11)
    takes milliseconds, not minutes. Noise is drawn directly in float32
    to halve the transient footprint at population scale.

    Returns stacked arrays ``(x (M, N, S, dim) f32, y (M, N, S) i32)``;
    feed them to ``repro_torch.data.federated.stack_virtual`` for the
    train/val split.
    """
    w = rng.normal(0, 1, (dim, num_classes)).astype(np.float32)
    c = rng.normal(0, 1, num_classes).astype(np.float32)
    scale = (np.arange(1, dim + 1, dtype=np.float64) ** -0.6
             ).astype(np.float32)                     # sqrt of diag(j^-1.2)
    mu_team = rng.normal(0, shift, (m_teams, 1, 1, dim)).astype(np.float32)
    v = mu_team + rng.standard_normal(
        (m_teams, n_devices, 1, dim), dtype=np.float32) * 0.1
    x = v + rng.standard_normal(
        (m_teams, n_devices, samples_per_device, dim),
        dtype=np.float32) * scale
    y = np.argmax(x @ w + c, axis=-1)
    return x, y.astype(np.int32)


def synthetic_images(rng: np.random.Generator, n_per_class: int, *,
                     num_classes: int = 10, shape=(28, 28, 1),
                     noise: float = 0.35, rank: int = 6,
                     class_sep: float = 0.35):
    """Class-conditional image generator: (x (C*n, *shape), y).

    Templates share a common base and differ by a `class_sep`-scaled
    deviation, so the 10-way global problem is genuinely hard at moderate
    noise while any 2-way per-device problem stays much easier — the
    structure that produces the paper's PM >> GM gap under label skew.
    """
    h, w, c = shape
    base_rng = np.random.default_rng(999)
    ub = base_rng.normal(0, 1, (h, rank))
    vb = base_rng.normal(0, 1, (rank, w))
    xs, ys = [], []
    for cls in range(num_classes):
        crng = np.random.default_rng(1000 + cls)  # fixed per-class templates
        u = ub + class_sep * crng.normal(0, 1, (h, rank))
        v = vb + class_sep * crng.normal(0, 1, (rank, w))
        template = np.tanh(u @ v / np.sqrt(rank))
        x = template[None, :, :, None] + rng.normal(0, noise,
                                                    (n_per_class, h, w, c))
        xs.append(x.astype(np.float32))
        ys.append(np.full(n_per_class, cls, np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


DATASETS = {
    # name -> (input_shape, num_classes) matching the paper's suite
    "mnist": ((28, 28, 1), 10),
    "fmnist": ((28, 28, 1), 10),
    "emnist10": ((28, 28, 1), 10),
    "femnist": ((28, 28, 1), 62),
    "cifar100": ((32, 32, 3), 100),
    "synthetic": ((60,), 10),
    "virtual": ((60,), 10),
}


def make_dataset(name: str, rng: np.random.Generator, n_per_class: int = 300):
    shape, ncls = DATASETS[name]
    if name == "synthetic":
        raise ValueError("use synthetic_tabular for the tabular dataset")
    if name == "virtual":
        raise ValueError("use virtual_tabular for the cohort-scale "
                         "tabular dataset")
    # different dataset name -> different noise level => different
    # difficulty ordering (mnist < emnist10 < fmnist, like the real suite)
    noise = {"mnist": 0.80, "fmnist": 1.10, "emnist10": 0.95,
             "femnist": 1.00, "cifar100": 1.30}[name]
    return synthetic_images(rng, n_per_class, num_classes=ncls, shape=shape,
                            noise=noise)
