"""Feature table: the SoA keypoint/descriptor container.

Counterpart of hessgpu_tpu/features.py: plain tensors plus a validity mask,
fixed capacity, an optional leading batch dimension on every leaf.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FeatureTable(NamedTuple):
    """Fixed-capacity feature set in *image* coordinates."""
    x: torch.Tensor          # f32 (..., N)
    y: torch.Tensor          # f32 (..., N)
    sigma: torch.Tensor      # f32 (..., N) scale in input-image units
    theta: torch.Tensor      # f32 (..., N) orientation, image frame (mirrored)
    response: torch.Tensor   # f32 (..., N)
    level: torch.Tensor      # i32 (..., N) flattened (octave * s + key_level - 1)
    ftype: torch.Tensor      # i32 (..., N) 0 dark blob / 1 bright blob / 2 saddle
    valid: torch.Tensor      # bool (..., N)
    desc: torch.Tensor       # f32 (..., N, 128) (or 64 half-SIFT); zeros if absent

    @property
    def capacity(self) -> int:
        return int(self.x.shape[-1])

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)


def to_numpy_trimmed(table: FeatureTable) -> dict:
    """Unbatched device table -> compact NumPy dict trimmed to the valid
    slots (copies to the host, so it waits for the device)."""
    valid = table.valid.cpu().numpy()
    out = {}
    for name in ("x", "y", "sigma", "theta", "response", "level", "ftype"):
        out[name] = getattr(table, name).cpu().numpy()[valid]
    out["desc"] = table.desc.cpu().numpy()[valid]
    return out


def keypoint_buffer(feats: dict) -> np.ndarray:
    """Pack the reference SiftKeypoint host buffer: 6 floats per keypoint
    (x, y, s, o, response, level<<16|type reinterpreted) - SiftGPU.h:108-122.

    The last item stores level and type as two u16s in one float's bits.
    """
    n = feats["x"].shape[0]
    buf = np.zeros((n, 6), dtype=np.float32)
    buf[:, 0] = feats["x"]
    buf[:, 1] = feats["y"]
    buf[:, 2] = feats["sigma"]
    buf[:, 3] = feats["theta"]
    buf[:, 4] = feats["response"]
    packed = (feats["level"].astype(np.uint32) & 0xFFFF) | (
        (feats["ftype"].astype(np.uint32) & 0xFFFF) << 16)
    buf[:, 5] = packed.view(np.float32)
    return buf
