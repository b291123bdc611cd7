"""SimpleSIFT on the PyTorch/CUDA port: detect features on two images,
match them, report the pairs. The port's counterpart of
examples/simple_sift.py (the reference's TestWin/SimpleSIFT.cpp:78-289),
with its remote mode: the port's feature server
(hessgpu_tpu_torch/csrc/hess_server.cpp, built at first use) spawned on
loopback and driven by the port's RemoteSift.

    python examples/simple_sift_torch.py [img1 img2] [--remote]
                                         [--device cuda|cpu]

Without images it writes two overlapping crops of one seeded texture
(hessgpu_tpu_torch.sfm.synthetic.texture_frame) as PGM files into a
temporary directory. --device defaults to cuda, which needs a CUDA card
and raises without one; pass --device cpu to run on the CPU.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile
from typing import List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hessgpu_tpu_torch import (HessianSift, SiftConfig,  # noqa: E402
                               SiftMatcher)
from hessgpu_tpu_torch.sfm.synthetic import texture_frame  # noqa: E402

# the default pair: crops of one texture, the second shifted by SHIFT
SEED, SHAPE, SHIFT = 30, (240, 320), (16, 24)


def default_images(directory: str) -> List[str]:
    """Two overlapping u8 crops of the seeded texture, written as PGMs."""
    (h, w), (dy, dx) = SHAPE, SHIFT
    big = (np.clip(texture_frame(SEED, h + dy, w + dx), 0, 1) * 255
           + 0.5).astype(np.uint8)
    paths = []
    for i, crop in enumerate((big[:h, :w], big[dy:, dx:])):
        path = os.path.join(directory, f"simple_sift_{i}.pgm")
        with open(path, "wb") as f:
            f.write(f"P5\n{w} {h}\n255\n".encode())
            f.write(np.ascontiguousarray(crop).tobytes())
        paths.append(path)
    return paths


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(img1: str, img2: str, device: str = "cuda", remote: bool = False,
        server_binary: Optional[str] = None):
    """Features of both images and their matches: (features1, features2,
    matches (K, 2)). In process a feature set is HessianSift.run's dict;
    over the server it is {"kp": (N, 6), "desc": (N, 128)}."""
    if remote:
        from hessgpu_tpu_torch.parallel.client import RemoteSift
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        with RemoteSift(port=_free_port(), spawn_args=["-device", device],
                        server_binary=server_binary, env=env) as server:
            if not server.initialize():
                raise RuntimeError(f"the feature server could not start on "
                                   f"{device}")
            feats = []
            for img in (img1, img2):
                server.run_sift(img)
                kp, desc = server.get_feature_vector()
                feats.append({"kp": kp, "desc": desc})
            server.match_set_descriptors(0, feats[0]["desc"])
            server.match_set_descriptors(1, feats[1]["desc"])
            matches = server.match()
        return feats[0], feats[1], matches
    sift = HessianSift(SiftConfig(), device=device)
    f1 = sift.run(img1)
    f2 = sift.run(img2)
    return f1, f2, SiftMatcher(device=device).match(f1, f2)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("images", nargs="*", help="two images (default: two "
                    "seeded texture crops)")
    ap.add_argument("--remote", action="store_true",
                    help="detect and match through the feature server")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if len(args.images) not in (0, 2):
        ap.error("give two images or none")
    with tempfile.TemporaryDirectory() as tmp:
        img1, img2 = args.images or default_images(tmp)
        f1, f2, matches = run(img1, img2, args.device, args.remote)
        for img, f in ((img1, f1), (img2, f2)):
            print(f"{img}: {len(f['desc'])} features")
    print(f"{len(matches)} matches")
    for i, j in matches[:10]:
        print(f"  {i} -> {j}")


if __name__ == "__main__":
    main()
