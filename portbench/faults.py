"""Faults planted in the program's timed path underneath a run: the tests
see ``correct`` come out false under each, and ``calibrate.py --fault``
reads the numbers they give on the card.  One card: no exchange between
chips to leave out.

- ``unchanged``: the component and weight updates hand back the model and
  the meta-state they were given (a step that leaves its state unchanged);
- ``half_batch``: the natural-gradient estimate sees every other valid
  window row, its means taken over the rest;
- ``altered``: the target's answer for the first row it evaluates is the
  second row's (an answer altered where it is produced);
- ``altered_background``: kernel B4 writes each row's answer one row
  early, every window row getting its neighbour's (answers altered where
  they are produced);
- ``altered_update``: the component update writes each slot's answer one
  slot early, every slot getting its neighbour's (answers altered where
  they are produced).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    getter = owner.__getitem__ if isinstance(owner, dict) else \
        (lambda key: getattr(owner, key))
    setter = owner.__setitem__ if isinstance(owner, dict) else \
        (lambda key, v: setattr(owner, key, v))
    old = getter(name)
    setter(name, value)
    try:
        yield
    finally:
        setter(name, old)


@contextlib.contextmanager
def unchanged():
    from gmmvi_tpu_torch.optimization import (component_updaters,
                                              weight_updaters)

    def same(model, meta, *args, **kw):
        return component_updaters.ComponentUpdateResult(model, meta)

    with _patched(component_updaters.UPDATERS, "trust-region", same), \
            _patched(weight_updaters.WEIGHT_UPDATERS, "trust-region",
                     lambda model, meta, *a, **k: (model, meta)):
        yield


@contextlib.contextmanager
def half_batch():
    from gmmvi_tpu_torch.optimization import ng_estimators

    stein = ng_estimators.stein_estimate

    def half(model, samples, sample_mask, *args, **kw):
        keep = torch.cumsum(sample_mask.to(torch.int64), 0) % 2 == 1
        return stein(model, samples, sample_mask & keep, *args, **kw)

    with _patched(ng_estimators, "stein_estimate", half):
        yield


@contextlib.contextmanager
def altered():
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    evaluate = GMMVI._eval_target

    def wrong(self, samples):
        lnpdfs, grads = evaluate(self, samples)
        if lnpdfs.shape[0] < 2:
            return lnpdfs, grads
        return (torch.cat([lnpdfs[1:2], lnpdfs[1:]]),
                torch.cat([grads[1:2], grads[1:]]))

    with _patched(GMMVI, "_eval_target", wrong):
        yield


@contextlib.contextmanager
def altered_background():
    from gmmvi_tpu_torch.optimization import sample_db

    background = sample_db.background

    def wrong(*args, **kw):
        out = background(*args, **kw)
        return torch.cat([out[1:], out[-1:]])

    with _patched(sample_db, "background", wrong):
        yield


@contextlib.contextmanager
def altered_update():
    from gmmvi_tpu_torch.optimization import component_updaters

    update = component_updaters.UPDATERS["trust-region"]

    def wrong(*args, **kw):
        model, meta = update(*args, **kw)

        def one_early(x):
            return torch.cat([x[1:], x[-1:]])

        return component_updaters.ComponentUpdateResult(model.replace(
            means=one_early(model.means), chols=one_early(model.chols),
            inv_chols=one_early(model.inv_chols)), meta)

    with _patched(component_updaters.UPDATERS, "trust-region", wrong):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "altered_background": altered_background,
          "altered_update": altered_update}
