"""Training and serving of the port's LM: the microbatched train step,
checkpoints, the decode-step wrapper, greedy generation and the
continuous-batching engine."""
from .checkpoint import (CheckpointManager, available_steps,
                         load_checkpoint, save_checkpoint)
from .serve_step import greedy_generate, make_serve_step
from .serving import Request, ServingEngine
from .train_step import (TrainConfig, init_train_state, loss_and_grads,
                         make_defer_train_step, make_train_step)

__all__ = ["CheckpointManager", "Request", "ServingEngine", "TrainConfig",
           "available_steps", "greedy_generate", "init_train_state",
           "load_checkpoint", "loss_and_grads", "make_defer_train_step", "make_serve_step",
           "make_train_step", "save_checkpoint"]
