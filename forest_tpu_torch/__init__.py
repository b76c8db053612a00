"""forest_tpu_torch: the PyTorch / CUDA port of forest_tpu for NVIDIA Hopper.

The JAX package ``forest_tpu`` stays the reference. This package keeps its
public layouts (channel-last NHWC) so the two can be compared like for like,
imports the host-side modules of ``forest_tpu`` that import no JAX
(bindings, cube builders, datasets, transform specs, the serving
micro-batcher and HTTP front), and replaces each Pallas TPU kernel on a
ported path with a hand-written CUDA kernel under ``csrc/``.

Ported so far: the serving path of the frozen FRL encoder
(``forest_tpu_torch.serving``).
"""

__version__ = "0.1.0"
