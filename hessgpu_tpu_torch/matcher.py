"""Descriptor matching (counterpart of hessgpu_tpu/matcher.py).

Equivalent of SiftMatchGPU/SiftMatchCU (reference SiftMatch.{h,cpp},
SiftMatchCU.{h,cpp}, matcher kernels ProgramCU.cu:3446-3843): one matrix
product and two argmax/masks.

  * descriptors are quantized u8 = int(512*d + 0.5) (SiftMatchCU.cpp:87-101);
    the integer dot matrix is a float32 product with TF32 off: u8 values and
    their 128-term sums (< 2^24) are exact in float32 whatever the order of
    the sum. The JAX package leaves this product to XLA (jnp.dot outside any
    kernel); here it is torch.matmul.
  * distance is angular: acos(dot / 512^2) (ProgramCU.cu:3790, constant
    0.000003814697265625 = 1/512^2).
  * row i matches col j iff j = argmax_j dot (the first of equal maxima),
    acos < distmax, and acos < ratiomax * acos(second best), the second best
    being the maximum with the argmax position masked: a tie rejects the row
    (ProgramCU.cu:3790-3793).
  * mutual-best check intersects row and column winners
    (SiftMatchCU.cpp:148-173).
  * guided matching gates pairs by homography distance and fundamental-matrix
    Sampson error before the descriptor test (ProgramCU.cu:3565-3731).
"""

from __future__ import annotations

import numpy as np
import torch

from .pyramid import resolve_device
from .utils.precision import full_f32_matmul

INV_512_SQ = 1.0 / (512.0 * 512.0)


def quantize_descriptors(desc: np.ndarray) -> np.ndarray:
    """float descriptors -> u8, reference quantization int(512*d + 0.5)."""
    return np.clip(np.floor(512.0 * desc + 0.5), 0, 255).astype(np.uint8)


def descriptor_dots(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Exact integer dot matrix (N1, N2) of u8 descriptors, as float32."""
    with full_f32_matmul():
        return d1.to(torch.float32) @ d2.to(torch.float32).T


def _match_core(d1, d2, valid1, valid2, distmax, ratiomax, mutual_best=True,
                gate=None):
    """d1 (N1, 128) u8, d2 (N2, 128) u8 tensors -> match index per row (or
    -1), int64 (N1,) on their device.

    gate: optional (N1, N2) bool mask of geometrically admissible pairs.
    """
    dots = descriptor_dots(d1, d2)
    vmask = valid1[:, None] & valid2[None, :]
    if gate is not None:
        vmask = vmask & gate
    dots = torch.where(vmask, dots, torch.full_like(dots, -1.0))

    def best_two(mat, dim):
        bv, bi = mat.max(dim=dim)          # the first of equal maxima
        # second best: mask out the argmax position
        nv = mat.scatter(dim, bi.unsqueeze(dim), -np.inf).amax(dim=dim)
        return bi, bv, nv

    def accept(bv, nv):
        dist = torch.arccos(torch.clamp(bv * INV_512_SQ, max=1.0))
        distn = torch.arccos(torch.clamp(nv * INV_512_SQ, -1.0, 1.0))
        return (dist < distmax) & (dist < distn * ratiomax)

    none = torch.tensor(-1, dtype=torch.int64, device=dots.device)
    ri, rv, rn = best_two(dots, 1)
    row_match = torch.where(accept(rv, rn) & (rv > 0), ri, none)

    if mutual_best:
        ci, cv, cn = best_two(dots, 0)
        col_match = torch.where(accept(cv, cn) & (cv > 0), ci, none)
        rows = torch.arange(d1.shape[0], device=dots.device)
        mutual = col_match[row_match.clamp(0, d2.shape[0] - 1)] == rows
        row_match = torch.where((row_match >= 0) & mutual, row_match, none)
    return row_match


def _guided_gate(loc1, loc2, H, hdistmax, F, fdistmax):
    """Geometric admissibility mask (N1, N2) of float32 tensors loc1 (N1, 2),
    loc2 (N2, 2), H and F (3, 3).

    Homography: |H*x1 - x2|_inf-style per-coordinate test; fundamental:
    Sampson error x2'Fx1 (ProgramCU.cu:3618-3643).
    """
    with full_f32_matmul():
        ones = torch.ones((loc1.shape[0], 1), dtype=loc1.dtype,
                          device=loc1.device)
        x1h = torch.cat([loc1, ones], dim=1)               # (N1, 3)
        hx = x1h @ H.T                                      # (N1, 3)
        hx = hx[:, :2] / hx[:, 2:3]
        dh = (hx[:, None, :] - loc2[None, :, :]).abs()      # (N1, N2, 2)
        hok = (dh[..., 0] < hdistmax) & (dh[..., 1] < hdistmax)

        fx1 = x1h @ F.T                                     # rows F*x1
        x2h = torch.cat([loc2, torch.ones((loc2.shape[0], 1),
                                          dtype=loc2.dtype,
                                          device=loc2.device)], dim=1)
        ftx2 = x2h @ F                                      # (N2, 3) F'*x2
        x2fx1 = fx1 @ x2h.T                                 # (N1, N2)
    denom = (fx1[:, 0] ** 2 + fx1[:, 1] ** 2)[:, None] + \
        (ftx2[:, 0] ** 2 + ftx2[:, 1] ** 2)[None, :]
    se = (x2fx1 ** 2) / denom
    return hok & (se < fdistmax)


class SiftMatcher:
    """Pairwise descriptor matcher (reference SiftMatchGPU API surface). It
    matches on the card unless it is asked for the CPU (device="cpu")."""

    def __init__(self, max_sift: int = 32768, device="cuda"):
        self.max_sift = max_sift
        self.device = resolve_device(device)
        self._desc = [None, None]
        self._loc = [None, None]

    # -- reference-style stateful API --------------------------------------
    def set_descriptors(self, index: int, desc: np.ndarray) -> None:
        """desc: (N, 128) float in [0,1] or uint8."""
        index = min(max(index, 0), 1)
        if desc.dtype != np.uint8:
            desc = quantize_descriptors(desc)
        self._desc[index] = desc[: self.max_sift]

    def set_feature_location(self, index: int, loc: np.ndarray) -> None:
        """loc: (N, 2) x, y positions (for guided matching)."""
        index = min(max(index, 0), 1)
        self._loc[index] = np.asarray(loc, np.float32)[: self.max_sift]

    def get_sift_match(self, distmax: float = 0.7, ratiomax: float = 0.8,
                       mutual_best: bool = True) -> np.ndarray:
        """Returns (M, 2) int array of (index1, index2) pairs."""
        return self._run(distmax, ratiomax, mutual_best, gate=None)

    def get_guided_sift_match(self, H: np.ndarray = None,
                              F: np.ndarray = None,
                              distmax: float = 0.7, ratiomax: float = 0.8,
                              hdistmax: float = 32.0, fdistmax: float = 16.0,
                              mutual_best: bool = True) -> np.ndarray:
        """Either matrix may be None to skip its gate: the reference
        substitutes identity with a 1e20 threshold (SiftMatch.cpp:663-675);
        both None degrades to plain matching."""
        if H is None and F is None:
            return self.get_sift_match(distmax, ratiomax, mutual_best)
        if H is None:
            H, hdistmax = np.eye(3, dtype=np.float32), 1.0e20
        if F is None:
            F, fdistmax = np.eye(3, dtype=np.float32), 1.0e20
        if self._loc[0] is None or self._loc[1] is None:
            raise ValueError("guided matching needs set_feature_location for "
                             "both images")
        gate = _guided_gate(
            self._tensor(self._loc[0]), self._tensor(self._loc[1]),
            self._tensor(np.asarray(H, np.float32)), hdistmax,
            self._tensor(np.asarray(F, np.float32)), fdistmax)
        return self._run(distmax, ratiomax, mutual_best, gate=gate)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run(self, distmax, ratiomax, mutual_best, gate) -> np.ndarray:
        d1, d2 = self._desc
        if d1 is None or d2 is None or len(d1) == 0 or len(d2) == 0:
            return np.zeros((0, 2), np.int32)
        v1 = torch.ones(d1.shape[0], dtype=torch.bool, device=self.device)
        v2 = torch.ones(d2.shape[0], dtype=torch.bool, device=self.device)
        rm = _match_core(self._tensor(d1), self._tensor(d2), v1, v2,
                         distmax, ratiomax, mutual_best=mutual_best,
                         gate=gate).cpu().numpy()
        rows = np.nonzero(rm >= 0)[0]
        return np.stack([rows, rm[rows]], axis=1).astype(np.int32)

    # -- one-shot convenience ----------------------------------------------
    def match(self, feats1: dict, feats2: dict, **kw) -> np.ndarray:
        self.set_descriptors(0, feats1["desc"])
        self.set_descriptors(1, feats2["desc"])
        return self.get_sift_match(**kw)
