"""State carried across from the JAX package.

The system has no learned weights; what crosses over is the configuration
and, for tests that feed one side's intermediate into the other, arrays.
Everything here takes plain Python / NumPy values, so this module needs
neither package's array library but torch.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from .config import SiftConfig
from .features import FeatureTable
from .ops.gather import LevelMaps, check_level_maps
from .pyramid import GlobalTable

# fields of the JAX SiftConfig that select TPU execution paths only
_DROPPED = ("canvas_bf16", "use_pallas")


def config_from_dict(d: Mapping) -> SiftConfig:
    """dataclasses.asdict() of the JAX package's SiftConfig -> the port's.
    The TPU-only switches are dropped; an unknown key is refused."""
    known = {f.name for f in dataclasses.fields(SiftConfig)}
    kw = {k: v for k, v in d.items() if k not in _DROPPED}
    unknown = sorted(set(kw) - known)
    if unknown:
        raise ValueError(f"config_from_dict: unknown keys {unknown}")
    if isinstance(kw.get("prealloc_size"), list):
        kw["prealloc_size"] = tuple(kw["prealloc_size"])
    return SiftConfig(**kw)


def feature_table_from_numpy(arrays: Mapping[str, np.ndarray],
                             device="cpu") -> FeatureTable:
    """A FeatureTable fetched to NumPy (one array per field) -> the port's
    FeatureTable of tensors."""
    dtypes = {"level": torch.int32, "ftype": torch.int32, "valid": torch.bool}
    missing = sorted(set(FeatureTable._fields) - set(arrays))
    if missing:
        raise ValueError(f"feature_table_from_numpy: missing {missing}")
    return FeatureTable(**{
        name: torch.as_tensor(np.array(arrays[name]), device=device)
        .to(dtypes.get(name, torch.float32))
        for name in FeatureTable._fields})


def octave_from_numpy(stack: np.ndarray, device="cpu") -> torch.Tensor:
    """A Gaussian stack (L, H, W) or (B, L, H, W) -> (B, L, H, W) float32
    tensor, the input layout of ops.cuda.detect.detect_octave."""
    t = torch.as_tensor(np.array(stack, np.float32), device=device)
    if t.ndim == 3:
        t = t[None]
    if t.ndim != 4:
        raise ValueError(f"octave_from_numpy: expected (L, H, W) or "
                         f"(B, L, H, W), got {tuple(t.shape)}")
    return t.contiguous()


def global_table_from_numpy(arrays: Mapping[str, np.ndarray],
                            device="cpu") -> GlobalTable:
    """The JAX package's GlobalTable (level coordinates) fetched to NumPy,
    one array per field, (G,) or (B, G) -> the port's GlobalTable with (B, G)
    leaves, the input of the orientation and descriptor stages."""
    dtypes = {"ftype": torch.int32, "level_id": torch.int32,
              "valid": torch.bool}
    missing = sorted(set(GlobalTable._fields) - set(arrays))
    if missing:
        raise ValueError(f"global_table_from_numpy: missing {missing}")
    out = {}
    for name in GlobalTable._fields:
        t = torch.as_tensor(np.array(arrays[name]), device=device) \
            .to(dtypes.get(name, torch.float32))
        if t.ndim == 1:
            t = t[None]
        if t.ndim != 2:
            raise ValueError(f"global_table_from_numpy: {name} must be (G,) "
                             f"or (B, G), got {tuple(t.shape)}")
        out[name] = t.contiguous()
    return GlobalTable(**out)


def level_maps_from_numpy(grads: Sequence[np.ndarray],
                          rots: Sequence[np.ndarray],
                          device="cpu") -> LevelMaps:
    """Per-level gradient magnitude / angle arrays, each (h, w) or (B, h, w),
    in level-id order -> the LevelMaps the port's per-keypoint stages take
    (every level a group of its own)."""
    def group(a):
        t = torch.as_tensor(np.array(a, np.float32), device=device)
        if t.ndim == 2:
            t = t[None]
        if t.ndim != 3:
            raise ValueError(f"level_maps_from_numpy: expected (h, w) or "
                             f"(B, h, w), got {tuple(t.shape)}")
        return t[:, None].contiguous()
    maps = LevelMaps(tuple(group(g) for g in grads),
                     tuple(group(r) for r in rots))
    check_level_maps(maps)
    return maps
