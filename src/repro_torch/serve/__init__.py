"""Model serving for fitted solver models (the counterpart of
``repro/serve``): persistable model artifacts, a multi-model registry
deduplicating device-resident state, a continuous-batching engine with
deadlines and bounded-queue load shedding, and online refit with an
atomic weight swap.

    from repro_torch.serve import ModelRegistry, ServingEngine

    est.fit(A, y); est.save("artifacts/churn")      # layer 1
    reg = ModelRegistry()
    reg.load("churn", "artifacts/churn")            # layers 1+2
    engine = ServingEngine(reg, slots=256)          # layer 3
    engine.warmup()
    t = engine.submit("churn", Xq, deadline_s=0.1)
    engine.step(); print(t.result)
    reg.refit("churn", X_new, y_new)                # layer 4

Everything runs on the card unless built with ``device="cpu"``
(``ModelRegistry(device=)``; registered estimators keep their own).
"""
from .artifacts import (MANIFEST_VERSION, ServableModel, load_model,
                        save_model)
from .engine import DONE, EXPIRED, PENDING, SHED, ServingEngine, Ticket
from .registry import ModelRegistry, ServeGroup, operator_key

__all__ = [
    "MANIFEST_VERSION", "ServableModel", "load_model", "save_model",
    "ModelRegistry", "ServeGroup", "operator_key",
    "ServingEngine", "Ticket", "PENDING", "DONE", "EXPIRED", "SHED",
]
