"""PyTorch/CUDA port of the FAL reproduction (``repro``), for NVIDIA Hopper.

Mirrors ``repro``'s layout (``configs/ core/ models/ kernels/ serve/
obs/``), one reference module per port module.  It imports torch and
numpy, never JAX and nothing of ``repro``; only the parity tests import
both.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
