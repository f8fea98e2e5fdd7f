"""Faults planted in the measured program, for showing that the check
catches them (the tests, and ``calibrate.py`` on the chip at a cell's
own size). Each :func:`plant` returns a function that takes the fault
out again.

* ``frozen``: a step that returns its state unchanged.
* ``half_batch``: half of every batch left out, the mean taken over
  the rest (half the sequence where a batch holds one row).
"""
from __future__ import annotations

FAULTS = ("frozen", "half_batch")


def _swap(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def plant(path: str, fault: str):
    """Plant ``fault`` in the program code that path ``path`` drives."""
    if fault not in FAULTS:
        raise ValueError(fault)
    if path == "fl_rounds":
        import repro_torch.core.algorithm as algorithm
        import repro_torch.core.permfl as permfl
        if fault == "frozen":
            return _swap(algorithm.PerMFL, "round",
                         lambda self, state, data, **kw: state)
        grads = permfl.device_grads

        def half(loss_fn, layout, theta, batch):
            b = batch["y"].shape[1]
            return grads(loss_fn, layout, theta,
                         {k: v[:, :b // 2] for k, v in batch.items()})
        return _swap(permfl, "device_grads", half)
    if path == "lm_tier":
        import repro_torch.train.trainer as trainer
        if fault == "frozen":
            make = trainer.make_tier_round

            def frozen(*args, **kw):
                fn = make(*args, **kw)

                def round_fn(theta, w, x, batch):
                    return (theta, w, x) + (fn(theta, w, x, batch)[3],)
                return round_fn
            return _swap(trainer, "make_tier_round", frozen)
        vag = trainer.value_and_grad

        def half(params, cfg, batch, **kw):
            b, s = batch["tokens"].shape
            cut = (slice(0, b // 2) if b > 1
                   else (slice(None), slice(0, s // 2)))
            return vag(params, cfg, {k: v[cut] for k, v in batch.items()},
                       **kw)
        return _swap(trainer, "value_and_grad", half)
    raise ValueError(path)
