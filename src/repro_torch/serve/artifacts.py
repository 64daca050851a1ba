"""Model artifacts: persist a fitted estimator, restore it cold (the
counterpart of ``repro/serve/artifacts.py``, layer 1 of
``repro_torch.serve``).

A *servable model* is everything the prediction path needs and nothing
the solve needed: the serving ``GramOperator`` (exact features + kernel
config, the streamed chunks, or the Nystrom factor + feature map), the
dual weights, the problem config (C/lam/loss), the RESOLVED
``SolverOptions`` the fit ran with, and — so a deployed model can absorb
fresh labeled traffic via ``ModelRegistry.refit`` — the raw training
data and targets.

On-disk format reuses the checkpoint machinery end to end
(``train/checkpoint.py`` atomic step directories, one .npy a leaf;
``resilience/checkpoint.operator_meta`` for the operator's static half),
under a VERSIONED manifest:

    <dir>/step_00000000/
        meta.json      {"serve_manifest": {"version": 1, "problem": ...,
                        "cfg": ..., "options": ..., "op_meta": ...,
                        "fingerprint": ...}}
        leaf_*.npy     alpha, y, op leaves, [A_raw for low-rank]

``load_model`` refuses manifests from a NEWER format version and
restores the fit fingerprint, so a registry can dedup device state across
models restored on different days (``registry.operator_key``).

Artifacts of the two packages are not readable across them, as their
checkpoints are not (``train/checkpoint.py``): the port's tree of
leaves, its operator meta and its options differ from the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.bdcd import KRRConfig
from repro_torch.core.dcd import SVMConfig
from repro_torch.core.kernels import (ExactGramOperator, KernelConfig,
                                      StreamingGramOperator)
from repro_torch.device import resolve_device
from repro_torch.resilience.checkpoint import (_op_from, _op_leaves,
                                               operator_meta,
                                               operator_template,
                                               options_meta)
from repro_torch.train.checkpoint import (available_steps, load_checkpoint,
                                          save_checkpoint)

MANIFEST_VERSION = 1
PROBLEMS = ("ksvm", "krr")


# repro: noqa[CHK-TREE] a registry's record of a fitted model; its own methods
#   move its tensors, no tree carries it
@dataclasses.dataclass
class ServableModel:
    """A fitted estimator reduced to its serving + refit essentials.

    ``problem`` is "ksvm" or "krr"; ``alpha`` the raw dual solution;
    ``y`` the training targets/labels (refit needs them; K-SVM serving
    folds them into the weights); ``op`` the UNSCALED serving operator
    the facade kept on ``op_``; ``A_raw`` the raw training features —
    carried for low-rank operators only (refit has to rebuild the
    feature map over the grown training set).
    """

    problem: str
    cfg: Union[SVMConfig, KRRConfig]
    options: object                      # resolved SolverOptions
    alpha: torch.Tensor
    y: torch.Tensor
    op: object                           # GramOperator
    A_raw: Optional[torch.Tensor] = None
    fingerprint: Optional[dict] = None

    def __post_init__(self):
        if self.problem not in PROBLEMS:
            raise ValueError(f"problem must be one of {PROBLEMS}, got "
                             f"{self.problem!r}")

    # -- serving surface ------------------------------------------------

    @property
    def serve_w(self) -> torch.Tensor:
        """The weight vector ``K(Xq, train) @ w`` serves, with every
        per-model scalar FOLDED IN (serving is linear in w): K-SVM
        decision values use ``alpha * y``; K-RR predictions ``alpha /
        lam``.  Registry groups stack these columns directly — one
        block call serves every model in the group."""
        if self.problem == "ksvm":
            return self.alpha * self.y
        return self.alpha / self.cfg.lam

    @property
    def features(self) -> torch.Tensor:
        """Raw training features (refit's base): ``op.A`` for exact
        operators, the m true rows of a streamed operator's host chunks,
        the separately-carried ``A_raw`` for low-rank."""
        if isinstance(self.op, ExactGramOperator):
            return self.op.A
        if isinstance(self.op, StreamingGramOperator):
            return self.op.Xc.view(-1, self.op.Xc.shape[2])[:self.op.m]
        if self.A_raw is None:
            raise ValueError(
                "low-rank model carries no raw training features "
                "(A_raw=None) — it can serve but not refit")
        return self.A_raw

    @classmethod
    def from_estimator(cls, est) -> "ServableModel":
        """Capture a fitted ``repro_torch.api`` estimator (``KernelSVM``
        / ``KernelRidge``)."""
        from repro_torch.api import KernelRidge, KernelSVM
        from repro_torch.resilience.checkpoint import solve_fingerprint

        if isinstance(est, KernelSVM):
            problem = "ksvm"
        elif isinstance(est, KernelRidge):
            problem = "krr"
        else:
            raise TypeError(f"expected a fitted KernelSVM/KernelRidge, "
                            f"got {type(est).__name__}")
        if not hasattr(est, "op_"):
            raise ValueError("estimator is not fitted (no op_) — call "
                             "fit() before registering/saving")
        opts = est.result_.options
        A_raw = (est.A_ if not isinstance(
            est.op_, (ExactGramOperator, StreamingGramOperator)) else None)
        fp = solve_fingerprint(problem, est.A_.shape[0], est.A_.dtype,
                               est.cfg, opts)
        return cls(problem=problem, cfg=est.cfg, options=opts,
                   alpha=est.alpha_, y=est.y_, op=est.op_, A_raw=A_raw,
                   fingerprint=fp)


def save_model(directory: str, model, *, step: int = 0) -> str:
    """Persist a ``ServableModel`` (or a fitted estimator, captured via
    ``ServableModel.from_estimator``) under a versioned manifest.
    Returns the checkpoint path."""
    from repro_torch.api import KernelRidge, KernelSVM

    if isinstance(model, (KernelSVM, KernelRidge)):
        model = ServableModel.from_estimator(model)
    tree = {"alpha": model.alpha, "y": model.y, "op": _op_leaves(model.op)}
    if model.A_raw is not None:
        tree["A_raw"] = model.A_raw
    manifest = {
        "version": MANIFEST_VERSION,
        "problem": model.problem,
        "cfg": dataclasses.asdict(model.cfg),     # kernel nests as a dict
        "options": options_meta(model.options),
        "op_meta": operator_meta(model.op),
        "has_A_raw": model.A_raw is not None,
        "fingerprint": model.fingerprint,
    }
    return save_checkpoint(directory, step, tree,
                           extra={"serve_manifest": manifest})


def load_model(directory: str, *, step: Optional[int] = None,
               device=None) -> ServableModel:
    """Restore a ``ServableModel`` from ``save_model`` output, its
    tensors on ``device`` (the card unless ``device="cpu"``; a streamed
    operator keeps its chunks on the host).  The operator is rebuilt from
    the manifest's ``op_meta`` — no live object needed; a manifest
    written by a NEWER format version is refused with the versions
    named."""
    from repro_torch.api import SolverOptions

    dev = resolve_device(device)
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no model artifact in {directory!r}")
    step = steps[-1] if step is None else step
    leaves, meta = load_checkpoint(directory, step=step)
    manifest = meta["extra"].get("serve_manifest")
    if manifest is None:
        raise ValueError(
            f"{directory!r} holds a checkpoint but not a serve model "
            f"artifact (no serve_manifest) — was it written by "
            f"save_fit/save_solve_state instead of save_model?")
    if manifest["version"] > MANIFEST_VERSION:
        raise ValueError(
            f"model artifact {directory!r} has manifest version "
            f"{manifest['version']} but this build reads <= "
            f"{MANIFEST_VERSION} — upgrade repro_torch before serving it")
    by_path = dict(zip(meta["paths"], leaves))
    op_meta = manifest["op_meta"]
    op = _op_from(operator_template(op_meta), op_meta,
                  {p.split("/", 1)[1]: t for p, t in by_path.items()
                   if p.startswith("op/")}, dev)
    return ServableModel(
        problem=manifest["problem"],
        cfg=_cfg_from_meta(manifest["problem"], manifest["cfg"]),
        options=SolverOptions(**manifest["options"]),
        alpha=by_path["alpha"].to(dev),
        y=by_path["y"].to(dev),
        op=op,
        A_raw=(by_path["A_raw"].to(dev) if manifest["has_A_raw"]
               else None),
        fingerprint=manifest["fingerprint"])


def _cfg_from_meta(problem: str, meta: dict):
    meta = dict(meta)
    kernel = KernelConfig(**meta.pop("kernel"))
    if problem == "ksvm":
        return SVMConfig(kernel=kernel, **meta)
    return KRRConfig(kernel=kernel, **meta)
