"""PyTorch and CUDA port of ``analytics_zoo_tpu`` for NVIDIA Hopper cards.

The layout mirrors the JAX package, so each module has a counterpart of the
same path there. The port imports nothing of JAX or of the JAX package. Its
entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; without a card they raise.
"""
__version__ = "0.1.0"
