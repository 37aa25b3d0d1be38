"""PyTorch + CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``src/repro``) is the reference; this package imports
nothing of it.  Module names mirror ``repro``'s so each module's
counterpart is easy to find.  Entry points run on the card unless the
caller passes ``device="cpu"`` (``repro_torch.device``).
"""
