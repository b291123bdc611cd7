"""Wrappers of the small-SVD kernels (csrc/linalg.cu), which replace no TPU
kernel: they hold the SVDs that the JAX package runs inside its jitted
RANSACs (hessgpu_tpu/sfm/twoview.py:52,55,127,129,234,237) in one captured
graph, reading nothing back to the host (torch.linalg.svd on the card reads
its convergence info back). Each stops its Jacobi sweeps by a test made on
the card (ops/linalg.py's JACOBI_TOL, capped at max_sweeps) and can write the
sweeps each matrix ran to an optional int32 tensor, which the tests and
chip_smoke.py read and the RANSAC cores do not ask for.

null_vector and svd3 take CUDA tensors only and launch their kernel there,
counting the launch; a CPU tensor raises. Their plain PyTorch versions,
the same algorithm step for step, are ops/linalg.py's null_vector_plain and
svd3_plain; the RANSAC cores choose between the kernels, LAPACK and the
plain versions by the tensor's device (sfm/twoview.py). Nothing falls back
from a failed build or launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import linalg
from . import build

_ptr = ctypes.c_void_p
_int, _double = ctypes.c_int, ctypes.c_double
_NULL_VECTOR_ARGTYPES = [_ptr] * 3 + [_int] * 4 + [_double, _int, _ptr]
_SVD3_ARGTYPES = [_ptr] * 5 + [_int, _double, _int, _double, _ptr]


def _on_card(name: str, A: torch.Tensor) -> None:
    if not A.is_cuda:
        raise ValueError(
            f"{name}: expected a CUDA tensor, got a {A.device} one (the "
            f"plain version is ops.linalg.{name}_plain)")


def _sweeps_ptr(sweeps, A: torch.Tensor) -> int:
    """The pointer of the optional sweeps output, which must be an int32
    tensor of A's batch shape on A's device (0 where there is none)."""
    if sweeps is None:
        return 0
    if sweeps.dtype != torch.int32 or sweeps.device != A.device \
            or tuple(sweeps.shape) != tuple(A.shape[:-2]) \
            or not sweeps.is_contiguous():
        raise ValueError(
            f"sweeps: expected a contiguous int32 tensor of shape "
            f"{tuple(A.shape[:-2])} on {A.device}, got {sweeps.dtype} "
            f"{tuple(sweeps.shape)} on {sweeps.device}")
    return sweeps.data_ptr()


def null_vector(A: torch.Tensor, max_sweeps: int = linalg.NULL_VECTOR_SWEEPS,
                sweeps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., n) float32: the unit right singular vector of the smallest
    singular value of each (M, n) matrix of A (..., M, n) float32, n <= 12,
    signed so that its first nonzero entry is positive - one launch of
    hg_null_vector (ops/linalg.py's docstring gives the algorithm, the
    convergence test and the cap max_sweeps). sweeps, an int32
    tensor of A's batch shape, receives the sweeps each matrix ran."""
    _on_card("null_vector", A)
    batch, M, n = linalg.check_null_vector_input(A)
    linalg.check_max_sweeps(max_sweeps)
    sweeps_ptr = _sweeps_ptr(sweeps, A)
    out = torch.empty(A.shape[:-2] + (n,), dtype=torch.float32,
                      device=A.device)
    if batch == 0:
        return out
    a = A.contiguous()
    fn = build.function("hg_null_vector", _NULL_VECTOR_ARGTYPES)
    with build.on_device_of(a):
        err = fn(a.data_ptr(), out.data_ptr(), sweeps_ptr, batch, M, n,
                 linalg.gram_slices(M, n), linalg.JACOBI_TOL, max_sweeps,
                 build.stream_of(a))
    build.check(err, "null_vector")
    build.count_launch("null_vector")
    return out


def svd3(A: torch.Tensor, max_sweeps: int = linalg.SVD3_SWEEPS,
         sweeps: Optional[torch.Tensor] = None):
    """(U, S, Vh) float32 of each 3 x 3 matrix of A (..., 3, 3) float32, as
    torch.linalg.svd gives them (S descending), by one launch of hg_svd3;
    max_sweeps and sweeps as in null_vector."""
    _on_card("svd3", A)
    batch = linalg.check_svd3_input(A)
    linalg.check_max_sweeps(max_sweeps)
    sweeps_ptr = _sweeps_ptr(sweeps, A)
    U, S, Vh = (torch.empty(A.shape[:-2] + s, dtype=torch.float32,
                            device=A.device) for s in ((3, 3), (3,), (3, 3)))
    if batch == 0:
        return U, S, Vh
    a = A.contiguous()
    fn = build.function("hg_svd3", _SVD3_ARGTYPES)
    with build.on_device_of(a):
        err = fn(a.data_ptr(), U.data_ptr(), S.data_ptr(), Vh.data_ptr(),
                 sweeps_ptr, batch, linalg.JACOBI_TOL, max_sweeps,
                 linalg.SVD3_RANK_TOL, build.stream_of(a))
    build.check(err, "svd3")
    build.count_launch("svd3")
    return U, S, Vh
