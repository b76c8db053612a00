"""Shared pieces of the forest_tpu_torch parity tests.

Inputs are made once with numpy from a seed and handed to both packages;
JAX runs on the CPU (tests/conftest.py), torch on the CPU. TF32 is off so a
float32 comparison means float32 on a card too.
"""
import numpy as np
import pytest
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def t(a) -> torch.Tensor:
    """numpy / jax array -> float32 CPU tensor (a copy)."""
    return torch.from_numpy(np.array(a, np.float32))


def softmax_np(x: np.ndarray, axis: int) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def bank_mix_inputs(rng, b, h, w, c, nd=4, r=4):
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    a_w = softmax_np(rng.normal(size=(b, h, w, 2 * nd, r)), 3)
    b_w = softmax_np(rng.normal(size=(b, h, w, c, r)), 4)
    return x, a_w, b_w


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README)")
    return torch.device("cuda", 0)
