"""Feature assembly on tensors: transforms, normalisation, whitening.

The bindings parser and the synthetic cube helpers are the JAX package's
own host code, which imports no JAX; they are re-exported here so that
callers of the port name only ``forest_tpu_torch``.
"""
from forest_tpu.data.bindings import parse_bindings
from forest_tpu.data.cube_v2 import (synthetic_bindings,
                                     synthetic_feature_stats,
                                     synthetic_frl_batch)

__all__ = ["parse_bindings", "synthetic_bindings", "synthetic_feature_stats",
           "synthetic_frl_batch"]
