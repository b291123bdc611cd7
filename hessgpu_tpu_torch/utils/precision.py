"""Float32 products at full precision.

The JAX package asks XLA for Precision.HIGHEST where a product must be exact
(the matcher's integer dots) or feeds a Krylov solver (bundle adjustment).
On the card PyTorch may run float32 matrix products in TF32, which keeps 10
mantissa bits; this block turns that off.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in IEEE float32 for the block (TF32 off on
    the card); the caller's setting comes back after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
