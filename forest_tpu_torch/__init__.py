"""forest_tpu_torch: the PyTorch / CUDA port of forest_tpu for NVIDIA Hopper.

The JAX package ``forest_tpu`` stays the reference. This package keeps its
public layouts (channel-last NHWC), module names and checkpoint format so
the two can be compared like for like, but imports nothing of it: the host
code it needs (bindings, cube readers and writers, datasets, samplers,
loaders, the serving micro-batcher and HTTP front) is its own copy. Every
Pallas TPU kernel of ``forest_tpu`` is a hand-written CUDA kernel under
``csrc/``, built with nvcc at first use.

Ported so far: serving the frozen FRL encoder (``serving``), the FRL
training step with every loss (``training.representation``) and the legacy
VQ-VAE (``training.train_vqvae``, ``eval.export_codebook``).
"""

__version__ = "0.1.0"
