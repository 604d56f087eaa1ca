"""PyTorch + CUDA port of pesr_tpu for NVIDIA Hopper (H100).

The JAX package ``pesr_tpu`` stays the reference; this package imports
nothing of it (nor of JAX) and keeps its own copies of what it needs.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""
