"""Checkpoint / resume for reconstructions (counterpart of
hessgpu_tpu/sfm/io.py).

A Reconstruction snapshots to one .npz and a long sequence can resume from
it (reconstruct_sequence(..., resume=...)). The layout is the JAX
package's, so a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import numpy as np

from .incremental import Reconstruction


def save_reconstruction(path: str, rec: Reconstruction) -> None:
    """Snapshot a Reconstruction to one compressed .npz."""
    obs = (np.asarray(rec.obs, np.float64).reshape(-1, 4)
           if rec.obs else np.zeros((0, 4)))
    tracks = (np.asarray(
        [(im, fi, tid) for (im, fi), tid in rec.track_of.items()],
        np.int64).reshape(-1, 3) if rec.track_of else
        np.zeros((0, 3), np.int64))
    view_ids = rec.view_ids if rec.view_ids is not None \
        else list(range(len(rec.R)))
    np.savez_compressed(
        path, R=np.stack(rec.R), t=np.stack(rec.t),
        K=np.asarray(rec.K), points=np.asarray(rec.points),
        obs=obs, tracks=tracks,
        view_ids=np.asarray(view_ids, np.int64))


def load_reconstruction(path: str) -> Reconstruction:
    from ..convert import reconstruction_from_numpy

    with np.load(path) as z:
        return reconstruction_from_numpy(z)
