"""Optimizers of the port's LM training (the counterpart of
``repro/optim``): AdamW as plain functions on the params tree, and the
int8 error-feedback compression of the deferred data-parallel sync."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    schedule)
from .compression import (BLOCK, compress_int8, decompress_int8,
                          error_feedback_compress, init_residual)

__all__ = ["AdamWConfig", "BLOCK", "adamw_init", "adamw_update",
           "compress_int8", "decompress_int8", "error_feedback_compress",
           "global_norm", "init_residual", "schedule"]
