"""The precision of the reference's float32 products."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 matrix products and cuDNN convolutions while the
    block runs when ``on``; the flags as they were after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
