"""Optimizers of the port's LM training (the counterpart of
``repro/optim``): AdamW as plain functions on the params tree.  The
int8 error-feedback compression of the JAX package serves only its
deferred data-parallel trainer (ROADMAP A11b)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "schedule"]
