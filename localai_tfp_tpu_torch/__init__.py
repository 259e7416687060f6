"""PyTorch/CUDA port of localai_tfp_tpu's serving path.

The JAX package (``localai_tfp_tpu``) is the reference; this package
imports ``torch`` and never ``jax`` or anything of the JAX package. Its
entry points run on a CUDA device unless the caller asks for the CPU
(``device="cpu"``), and every TPU kernel of the ported path is a
hand-written Hopper kernel under ``csrc/`` with a plain PyTorch version
beside it.
"""
