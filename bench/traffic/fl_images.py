"""Federated image data for the paper's FL cells, from the run's seed.

Frozen copy of the program's generator (``repro_torch.data.synthetic.
synthetic_images`` / ``make_dataset``, and ``repro_torch.data.federated.
partition_label_skew`` with the "random" team pools): class-conditional
28x28 images (a class template of low rank plus noise) stand in for the
paper's MNIST-family sets, each device holds ``classes_per_device``
classes, and a 3:1 train/validation split. One numpy generator seeded
with the run's seed draws the images and the partition.
"""
from __future__ import annotations

import numpy as np

# noise of each stand-in set, the program's difficulty ordering
NOISE = {"mnist": 0.80, "fmnist": 1.10, "emnist10": 0.95}


def synthetic_images(rng, n_per_class: int, *, num_classes: int, shape,
                     noise: float, rank: int = 6, class_sep: float = 0.35):
    """(x (C * n, *shape) float32, y (C * n,) int32), shuffled. The class
    templates are fixed (their own generators); the noise and the order
    come from ``rng``."""
    h, w, c = shape
    base_rng = np.random.default_rng(999)
    ub = base_rng.normal(0, 1, (h, rank))
    vb = base_rng.normal(0, 1, (rank, w))
    xs, ys = [], []
    for cls in range(num_classes):
        crng = np.random.default_rng(1000 + cls)
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


def _pools(rng, y, num_classes):
    """Each class's indices, shuffled."""
    return {c: rng.permutation(np.where(y == c)[0])
            for c in range(num_classes)}


def federation(data: dict, seed: int) -> dict:
    """{"train_x", "train_y", "val_x", "val_y"}: numpy arrays leading
    (M, N, samples) for the federation ``data`` describes (``dataset``,
    ``m_teams``, ``n_devices``, ``samples_per_device``,
    ``classes_per_device``, ``input_shape``, ``num_classes``)."""
    rng = np.random.default_rng(seed)
    m, n = data["m_teams"], data["n_devices"]
    spd, cpd = data["samples_per_device"], data["classes_per_device"]
    ncls = data["num_classes"]
    x, y = synthetic_images(rng, 40 * n, num_classes=ncls,
                            shape=tuple(data["input_shape"]),
                            noise=NOISE[data["dataset"]])
    pools = _pools(rng, y, ncls)
    cursor = {c: 0 for c in range(ncls)}

    def take(c, k):
        idx = pools[c]
        out = [idx[(cursor[c] + i) % len(idx)] for i in range(k)]
        cursor[c] = (cursor[c] + k) % len(idx)
        return np.array(out)

    xs = np.zeros((m, n, spd) + x.shape[1:], np.float32)
    ys = np.zeros((m, n, spd), np.int32)
    for i in range(m):
        for j in range(n):
            classes = rng.choice(ncls, size=cpd, replace=False)
            per, rem = spd // cpd, spd % cpd
            idx = np.concatenate([take(c, per + (1 if k < rem else 0))
                                  for k, c in enumerate(classes)])
            rng.shuffle(idx)
            xs[i, j] = x[idx]
            ys[i, j] = y[idx]
    n_val = max(1, int(spd * 0.25))
    return {"train_x": xs[:, :, n_val:], "train_y": ys[:, :, n_val:],
            "val_x": xs[:, :, :n_val], "val_y": ys[:, :, :n_val]}
