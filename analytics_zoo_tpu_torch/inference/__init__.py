"""Pooled, shape-bucketed inference over a loaded model."""
from .inference_model import InferenceModel

__all__ = ["InferenceModel"]
