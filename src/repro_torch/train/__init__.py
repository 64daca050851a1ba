"""Serving of the port's LM: the decode-step wrapper, greedy generation
and the continuous-batching engine."""
from .serve_step import greedy_generate, make_serve_step
from .serving import Request, ServingEngine

__all__ = ["Request", "ServingEngine", "greedy_generate", "make_serve_step"]
