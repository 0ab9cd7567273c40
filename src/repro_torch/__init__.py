"""Distributed GraphLab (arXiv:1204.6078) on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100, laid out module for
module like it.  It imports neither ``jax`` nor ``repro``.  Builders and
engines run on the card (``device="cuda"``) unless asked for the CPU.
"""
