"""Multi-model registry with shared device-resident state (the
counterpart of ``repro/serve/registry.py``, layer 2 of
``repro_torch.serve``).

Deployments serve MANY models against the same data: a regularization
grid's survivors, per-segment classifiers on one embedding table, an
A/B pair.  Loading each model's operator separately duplicates the
dominant memory — the (m, n) training features (exact) or the (m, l)
factor (Nystrom) — once per model.  This registry applies the fleet
trick at serving time:

  * models whose operators carry the SAME data (content-hashed:
    ``operator_key``) join one *group* holding a single device-resident
    ``GramOperator``;
  * a group's weights stack into ONE (m, F) matrix (each column a
    model's ``serve_w`` — per-model scalars like 1/lam folded in, since
    serving is linear in w), served through one ``serve_block`` call per
    query block: F models for one KMV launch;
  * ``refit(name, X_new, y_new)`` absorbs fresh labeled traffic through
    the facade's ``warm_start=`` path (old alpha zero-padded over the new
    rows; one representation build) and ATOMICALLY swaps the new model
    in: group state is rebuilt fully before the name is repointed, and a
    generation counter tells long-lived engines to refresh their
    snapshots — blocks already formed finish on the old weights, the
    next block sees the new ones, nothing ever sees a mix.

The registry is the model-management layer only; request batching,
deadlines and load shedding live in ``serve.engine.ServingEngine``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional

import torch

from repro_torch.core.predict import (BatchedPredictor, check_queries,
                                      validate_queries)
from repro_torch.device import as_tensor, resolve_device
from repro_torch.resilience.checkpoint import _op_leaves, operator_meta
from .artifacts import ServableModel, load_model, save_model


def operator_key(op) -> str:
    """Content identity of an operator's data: sha1 over its static half
    (``operator_meta``, the reference's treedef) plus every leaf's name,
    dtype, shape and bytes.  Two models fitted (or restored from
    artifacts written months apart) against one X and one kernel config
    hash identically — the dedup key that lets the registry keep ONE
    device-resident copy.  The data is copied to the host and read once
    per call (a full-width A of 655 MB included), so the registry calls
    it once per registration, never on the serving path."""
    h = hashlib.sha1(json.dumps(operator_meta(op), sort_keys=True).encode())
    for name, leaf in sorted(_op_leaves(op).items()):
        t = leaf.detach().contiguous().cpu()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


class ServeGroup:
    """One shared operator + the stacked weights of every member model.

    ``W`` is (m, F) with ``col[name]`` naming each model's column; the
    ``BatchedPredictor`` over (op, W) precomputes ``serve_weights`` once
    for the whole group and answers any query block with (q, F) values
    in one reduction.  Groups are rebuilt WHOLE on membership change
    (registration order preserved) — cheap host work, and the old
    predictor stays valid for any block already formed."""

    def __init__(self, op, *, predict_batch: int = 1024):
        self.op = op
        self.names: List[str] = []
        self.col: Dict[str, int] = {}
        self.W: Optional[torch.Tensor] = None
        self.predictor: Optional[BatchedPredictor] = None
        self.predict_batch = predict_batch

    @property
    def size(self) -> int:
        return len(self.names)

    @property
    def nbytes(self) -> int:
        """Bytes the group holds: the operator's data (host-resident for a
        streamed operator) and the stacked weights."""
        data = sum(t.numel() * t.element_size()
                   for t in _op_leaves(self.op).values())
        return data + (0 if self.W is None
                       else self.W.numel() * self.W.element_size())

    def rebuild(self, models: Dict[str, ServableModel]) -> None:
        self.col = {n: j for j, n in enumerate(self.names)}
        self.W = torch.stack([models[n].serve_w.to(self.op.device)
                              for n in self.names], dim=1)
        self.predictor = BatchedPredictor(self.op, self.W,
                                          batch=self.predict_batch)

    def serve(self, Xq) -> torch.Tensor:
        """(q, F) decision values/predictions for every member."""
        return self.predictor(Xq)

    def warmup(self) -> int:
        return self.predictor.warmup()


class ModelRegistry:
    """Layer 2 of ``repro_torch.serve``: named models, deduped device
    state.

    ``register`` accepts a fitted estimator or a ``ServableModel``;
    ``load``/``save`` go through the artifact layer (``load`` restores
    onto ``device``: the card unless ``device="cpu"``); ``predict``
    serves one model's queries through its group's stacked predictor
    (the same path the engine batches into); ``refit`` grows a model's
    training set in place.  ``generation`` increments on every mutation
    that changes what serving would return — engines pick it up at a
    step boundary.
    """

    def __init__(self, *, predict_batch: int = 1024, device=None):
        self.models: Dict[str, ServableModel] = {}
        self._groups: Dict[str, ServeGroup] = {}
        self._group_of: Dict[str, str] = {}
        self.predict_batch = predict_batch
        self.device = resolve_device(device)
        self.generation = 0

    # -- membership -----------------------------------------------------

    def _key_of(self, op) -> str:
        """The group key of ``op``: a group's own operator object is known
        without reading its data again; anything else is hashed."""
        for key, group in self._groups.items():
            if group.op is op:
                return key
        return operator_key(op)

    def register(self, name: str, model) -> ServableModel:
        """Add (or replace) a named model, joining the group holding its
        operator's data if one exists."""
        from repro_torch.api import KernelRidge, KernelSVM

        if isinstance(model, (KernelSVM, KernelRidge)):
            model = ServableModel.from_estimator(model)
        if not isinstance(model, ServableModel):
            raise TypeError(f"register expects a fitted estimator or a "
                            f"ServableModel, got {type(model).__name__}")
        if name in self.models:
            self.unregister(name)
        key = self._key_of(model.op)
        group = self._groups.get(key)
        if group is None:
            group = ServeGroup(model.op, predict_batch=self.predict_batch)
            self._groups[key] = group
        else:
            # share the group's device-resident operator: the new model's
            # (identical-content) copy is dropped
            model = dataclasses.replace(model, op=group.op)
        self.models[name] = model
        group.names.append(name)
        self._group_of[name] = key
        group.rebuild(self.models)
        self.generation += 1
        return model

    def unregister(self, name: str) -> None:
        key = self._group_of.pop(name)
        group = self._groups[key]
        group.names.remove(name)
        del self.models[name]
        if group.names:
            group.rebuild(self.models)
        else:
            del self._groups[key]
        self.generation += 1

    def save(self, name: str, directory: str) -> str:
        return save_model(directory, self._model(name))

    def load(self, name: str, directory: str) -> ServableModel:
        return self.register(name, load_model(directory, device=self.device))

    # -- introspection --------------------------------------------------

    def _model(self, name: str) -> ServableModel:
        if name not in self.models:
            raise KeyError(f"no model {name!r} registered (have "
                           f"{sorted(self.models)})")
        return self.models[name]

    def group(self, name: str) -> ServeGroup:
        self._model(name)
        return self._groups[self._group_of[name]]

    @property
    def n_groups(self) -> int:
        return len(self._groups)

    def groups(self) -> List[ServeGroup]:
        return list(self._groups.values())

    def warmup(self) -> int:
        """Serve every group's bucket set once; returns the total bucket
        count.  After this, steady traffic through ``predict`` / the
        engine reaches no new block shape (``serve_cache_size``)."""
        return sum(g.warmup() for g in self._groups.values())

    # -- serving --------------------------------------------------------

    def predict(self, name: str, Xq) -> torch.Tensor:
        """One model's values for a query block — served through the
        GROUP predictor (all F columns computed, one selected), so this
        path and the engine's batched path launch the same kernels."""
        model = self._model(name)
        Xq = validate_queries(model.op, Xq, name="Xq")
        group = self.group(name)
        return group.serve(Xq)[:, group.col[name]]

    # -- online refit ---------------------------------------------------

    def refit(self, name: str, X_new, y_new, *, options=None,
              schedule=None):
        """Absorb fresh labeled traffic into a deployed model: fit on
        ``concat(X_old, X_new)`` warm-started from the current alpha
        (zero-padded over the new rows — the facade's ``warm_start=``
        path, one representation build), then atomically swap the served
        weights.  Returns the new fit's ``FitResult``.

        ``schedule`` replays a given coordinate schedule (a parity test
        passes the reference refit's ``FitResult.schedule``); without it
        the fit draws its own from ``options.seed``.  The refitted
        model's operator covers a DIFFERENT training set, so it leaves
        its old group (siblings keep the old shared operator) and
        joins/forms the group matching the grown data.  Run with a
        tolerance (``options`` overrides the stored ones) and the warm
        start is equivalent to a cold fit on the combined data within
        the stopping tolerance."""
        from repro_torch.api import KernelRidge, KernelSVM

        model = self._model(name)
        X_new = check_queries(model.op, X_new, name="X_new")
        y_new = as_tensor(y_new)
        if y_new.shape[0] != X_new.shape[0]:
            raise ValueError(
                f"y_new has {y_new.shape[0]} rows but X_new has "
                f"{X_new.shape[0]} — refit needs one label per row")
        A_old = model.features
        A = torch.cat([A_old, X_new.to(A_old.device)])
        y = torch.cat([model.y, y_new.to(model.y.device, model.y.dtype)])
        a0 = torch.cat([model.alpha, model.alpha.new_zeros(X_new.shape[0])])
        opts = options if options is not None else model.options
        kw = dict(kernel=model.cfg.kernel, options=opts,
                  predict_batch=self.predict_batch, device=model.op.device)
        if model.problem == "ksvm":
            est = KernelSVM(C=model.cfg.C, loss=model.cfg.loss, **kw)
        else:
            est = KernelRidge(lam=model.cfg.lam, **kw)
        result = est.fit(A, y, warm_start=a0, schedule=schedule)
        # atomic swap: the new group state is fully built by register()
        # before the name points at it, so an engine refreshes at a step
        # boundary and never serves a half-updated group
        self.register(name, est)
        return result
