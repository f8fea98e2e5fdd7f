"""Non-IID federated partitioning + team assembly (paper §4 / §D.2.7).

The paper's dissemination: each device holds data from at most
``classes_per_device`` classes (2 for MNIST-family, 3 for FEMNIST/CIFAR100);
devices are then grouped into teams, either randomly or per a team-formation
label-pool strategy (worst/average case, §4.1.4). Output is the *stacked*
layout PerMFL consumes: arrays with leading (M, N, S).

Beyond the paper's label-skew dissemination, two further heterogeneity
regimes are available as first-class partitioners (surfaced through the
``repro_torch.scenarios`` registry):

  * ``partition_dirichlet`` — statistical label skew: each device's class
    mix is drawn from Dir(alpha); alpha -> 0 recovers single-class
    devices, alpha -> inf recovers IID.
  * ``partition_quantity_skew`` — quantity skew: devices hold power-law
    distributed *effective* dataset sizes (unique-sample counts) while
    the stacked layout stays rectangular.

All partitioners draw per-class samples through one shared ``_ClassPool``
that detects exhaustion: when cumulative demand for a class exceeds its
pool, samples are silently reused across devices (and potentially across
a device's train/val split), which can inflate accuracy — the pool now
warns with per-class reuse factors instead of wrapping silently.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch.core.team_formation import label_pools


@dataclass
class FederatedData:
    """Stacked train/val tensors: x (M,N,S,...) f32, y (M,N,S) i32."""
    train_x: np.ndarray
    train_y: np.ndarray
    val_x: np.ndarray
    val_y: np.ndarray

    @property
    def m_teams(self):
        return self.train_x.shape[0]

    @property
    def n_devices(self):
        return self.train_x.shape[1]

    def train_batch(self):
        return {"x": self.train_x, "y": self.train_y}

    def val_batch(self):
        return {"x": self.val_x, "y": self.val_y}


class _ClassPool:
    """Per-class shuffled index pools with cumulative-demand accounting.

    ``take(c, n)`` hands out the next ``n`` indices of class ``c``,
    wrapping modulo the pool exactly like the historical inline helper
    (so existing partitions are bit-identical) — but it records how much
    of each class was consumed, and ``warn_if_exhausted`` reports any
    class whose demand exceeded its pool (i.e. samples were reused).
    """

    def __init__(self, rng: np.random.Generator, y: np.ndarray,
                 num_classes: int):
        self.by_class = {c: np.where(y == c)[0] for c in range(num_classes)}
        for c in self.by_class:
            self.by_class[c] = rng.permutation(self.by_class[c])
        self.cursor = {c: 0 for c in range(num_classes)}
        self.taken = {c: 0 for c in range(num_classes)}

    def take(self, c: int, n: int) -> np.ndarray:
        idx = self.by_class[c]
        start = self.cursor[c]
        out = [idx[(start + i) % len(idx)] for i in range(n)]
        self.cursor[c] = (start + n) % len(idx)
        self.taken[c] += n
        return np.array(out)

    def warn_if_exhausted(self, where: str) -> None:
        reused = {c: self.taken[c] / len(self.by_class[c])
                  for c in self.taken
                  if self.taken[c] > len(self.by_class[c])}
        if reused:
            detail = ", ".join(f"class {c}: {r:.1f}x its pool of "
                               f"{len(self.by_class[c])}"
                               for c, r in sorted(reused.items()))
            warnings.warn(
                f"{where}: class pool(s) exhausted — samples are reused "
                f"across devices (and possibly across a device's "
                f"train/val split), which can inflate accuracy ({detail}). "
                f"Grow the dataset (n_per_class) or shrink "
                f"samples_per_device.", UserWarning, stacklevel=3)


def _split_train_val(xs, ys, samples_per_device: int, val_fraction: float):
    """First n_val samples of each device are validation (3:1 split as in
    the paper); per-device order was shuffled by the partitioner."""
    n_val = max(1, int(samples_per_device * val_fraction))
    return FederatedData(
        train_x=xs[:, :, n_val:], train_y=ys[:, :, n_val:],
        val_x=xs[:, :, :n_val], val_y=ys[:, :, :n_val])


def stack_virtual(xs, ys, *, samples_per_device: int,
                  val_fraction: float = 0.25) -> FederatedData:
    """Wrap pre-stacked (M, N, S, ...) arrays — e.g. from
    ``repro_torch.data.synthetic.virtual_tabular`` — as FederatedData with the
    standard 3:1 train/val split. The cohort-scale path: no per-device
    partitioning loop ever touches the population."""
    return _split_train_val(xs, ys, samples_per_device, val_fraction)


def partition_label_skew(rng: np.random.Generator, x, y, *, m_teams: int,
                         n_devices: int, classes_per_device: int = 2,
                         samples_per_device: int = 64,
                         strategy: str = "random",
                         val_fraction: float = 0.25) -> FederatedData:
    """Give each device `classes_per_device` classes drawn from its team's
    label pool, then `samples_per_device` samples of those classes
    (3:1 train/val split as in the paper)."""
    num_classes = int(y.max()) + 1
    pools = label_pools(strategy, m_teams, num_classes)
    pool = _ClassPool(rng, y, num_classes)

    xs = np.zeros((m_teams, n_devices, samples_per_device) + x.shape[1:],
                  np.float32)
    ys = np.zeros((m_teams, n_devices, samples_per_device), np.int32)
    for i in range(m_teams):
        team_pool = pools[i]
        for j in range(n_devices):
            classes = rng.choice(team_pool,
                                 size=min(classes_per_device,
                                          len(team_pool)), replace=False)
            per = samples_per_device // len(classes)
            rem = samples_per_device - per * len(classes)
            idx = np.concatenate(
                [pool.take(c, per + (1 if k < rem else 0))
                 for k, c in enumerate(classes)])
            rng.shuffle(idx)
            xs[i, j] = x[idx]
            ys[i, j] = y[idx]
    pool.warn_if_exhausted("partition_label_skew")
    return _split_train_val(xs, ys, samples_per_device, val_fraction)


def partition_dirichlet(rng: np.random.Generator, x, y, *, m_teams: int,
                        n_devices: int, alpha: float = 0.5,
                        samples_per_device: int = 64,
                        strategy: str = "random",
                        val_fraction: float = 0.25) -> FederatedData:
    """Dirichlet label skew: each device's class proportions are drawn
    from Dir(alpha) over its team's label pool, then its
    ``samples_per_device`` samples follow that multinomial mix.

    alpha -> 0 concentrates each device on ~1 class (harsher than the
    paper's fixed 2-class skew); alpha -> inf approaches IID devices.
    The team-formation ``strategy`` composes as in
    ``partition_label_skew`` (worst/average restrict team pools).
    """
    if alpha <= 0.0:
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    num_classes = int(y.max()) + 1
    pools = label_pools(strategy, m_teams, num_classes)
    pool = _ClassPool(rng, y, num_classes)

    xs = np.zeros((m_teams, n_devices, samples_per_device) + x.shape[1:],
                  np.float32)
    ys = np.zeros((m_teams, n_devices, samples_per_device), np.int32)
    for i in range(m_teams):
        team_pool = list(pools[i])
        for j in range(n_devices):
            p = rng.dirichlet(np.full(len(team_pool), alpha))
            counts = rng.multinomial(samples_per_device, p)
            idx = np.concatenate(
                [pool.take(c, k)
                 for c, k in zip(team_pool, counts) if k > 0])
            rng.shuffle(idx)
            xs[i, j] = x[idx]
            ys[i, j] = y[idx]
    pool.warn_if_exhausted("partition_dirichlet")
    return _split_train_val(xs, ys, samples_per_device, val_fraction)


def partition_quantity_skew(rng: np.random.Generator, x, y, *,
                            m_teams: int, n_devices: int,
                            samples_per_device: int = 64,
                            min_frac: float = 0.25,
                            val_fraction: float = 0.25) -> FederatedData:
    """Quantity skew: devices draw power-law *unique*-sample counts.

    Each device holds ``u`` unique samples (IID over classes) with
    ``u`` power-law distributed in [max(n_val+1, min_frac*S), S]; the
    stacked layout stays rectangular by cycling the device's *train*
    uniques to fill its train slots. Validation rows are always unique
    and never appear among the train rows, so train/val stay disjoint
    per device — the heterogeneity is purely in effective dataset size.
    """
    if not 0.0 < min_frac <= 1.0:
        raise ValueError(f"min_frac must be in (0, 1], got {min_frac}")
    S = samples_per_device
    n_val = max(1, int(S * val_fraction))
    lo = max(n_val + 1, int(np.ceil(min_frac * S)))
    if lo > S:
        raise ValueError(
            f"samples_per_device={S} too small for val_fraction="
            f"{val_fraction} (needs > {n_val + 1} unique samples)")

    order = rng.permutation(len(y))       # one global shuffled pool
    cursor = 0

    # power-law unique counts: most devices near `lo`, a heavy tail at S
    u_frac = rng.power(0.4, size=(m_teams, n_devices))
    uniques = (lo + np.round(u_frac * (S - lo))).astype(int)
    if int(uniques.sum()) > len(order):   # realized demand, not the bound
        warnings.warn(
            f"partition_quantity_skew: devices draw {int(uniques.sum())} "
            f"unique samples from a pool of {len(order)} — the pool wraps "
            f"and samples are reused across devices, which can inflate "
            f"accuracy. Grow the dataset or shrink samples_per_device.",
            UserWarning, stacklevel=2)

    xs = np.zeros((m_teams, n_devices, S) + x.shape[1:], np.float32)
    ys = np.zeros((m_teams, n_devices, S), np.int32)
    for i in range(m_teams):
        for j in range(n_devices):
            u = int(uniques[i, j])
            idx = np.array([order[(cursor + k) % len(order)]
                            for k in range(u)])
            cursor += u
            # val: first n_val uniques; train: remaining uniques cycled
            train_u = idx[n_val:]
            fill = train_u[np.resize(np.arange(len(train_u)), S - n_val)]
            rng.shuffle(fill)
            dev = np.concatenate([idx[:n_val], fill])
            xs[i, j] = x[dev]
            ys[i, j] = y[dev]
    return _split_train_val(xs, ys, S, val_fraction)


def partition_tabular(devices, *, m_teams: int, n_devices: int,
                      samples_per_device: int = 64,
                      val_fraction: float = 0.25) -> FederatedData:
    """Stack the per-device synthetic tabular data (truncate/cycle to a
    common per-device sample count so the stacked layout is rectangular)."""
    assert len(devices) >= m_teams * n_devices
    dim = devices[0][0].shape[1]
    xs = np.zeros((m_teams, n_devices, samples_per_device, dim), np.float32)
    ys = np.zeros((m_teams, n_devices, samples_per_device), np.int32)
    it = iter(devices)
    for i in range(m_teams):
        for j in range(n_devices):
            dx, dy = next(it)
            idx = np.resize(np.arange(len(dy)), samples_per_device)
            xs[i, j] = dx[idx]
            ys[i, j] = dy[idx]
    return _split_train_val(xs, ys, samples_per_device, val_fraction)
