"""Visualization dumps: the reference viewer's 7 views, as image files (the
port's counterpart of hessgpu_tpu/utils/viz.py; PNGs through Pillow, imported
when a view is written).

Replaces SiftGPUEX's interactive GL viewer (reference SiftGPU.cpp:716-787:
input, Gaussian pyramid, octave, level, response map, gradient, keypoints)
with matplotlib/PNG dumps - and the DEBUG_SIFTGPU intermediate-dump path
(SiftPyramid.cpp:573-635) with an explicit dump_intermediates() call.

Keypoints are colored by type like the reference display kernel
(ProgramCU.cu:3199-3218): dark blob = red, bright blob = green,
saddle = blue.
"""

from __future__ import annotations

import os
import numpy as np

TYPE_COLORS = {0: (1.0, 0.2, 0.2), 1: (0.2, 1.0, 0.2), 2: (0.3, 0.4, 1.0)}


def _save_gray(path: str, arr: np.ndarray, normalize: bool = True):
    from PIL import Image
    a = np.asarray(arr, np.float32)
    if normalize:
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / (hi - lo + 1e-12)
    Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8)).save(path)


def draw_keypoints(image: np.ndarray, feats: dict,
                   scale_rings: bool = True) -> np.ndarray:
    """Render typed keypoints onto an RGB copy of the image."""
    img = np.asarray(image, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    out = img.copy()
    h, w = out.shape[:2]
    for i in range(feats["x"].shape[0]):
        x, y = int(round(float(feats["x"][i]))), int(round(float(feats["y"][i])))
        r = max(2, int(round(float(feats["sigma"][i]) * 2))) if scale_rings else 3
        color = TYPE_COLORS.get(int(feats.get("ftype", np.zeros(1))[i] if
                                    "ftype" in feats else 0), (1, 1, 0))
        # draw a circle outline
        for ang in np.linspace(0, 2 * np.pi, max(16, 4 * r), endpoint=False):
            px = int(round(x + r * np.cos(ang)))
            py = int(round(y + r * np.sin(ang)))
            if 0 <= px < w and 0 <= py < h:
                out[py, px] = color
        # orientation tick
        th = float(feats["theta"][i])
        for rr in range(r):
            px = int(round(x + rr * np.cos(th)))
            py = int(round(y + rr * np.sin(th)))
            if 0 <= px < w and 0 <= py < h:
                out[py, px] = color
    return out


def colorize_response(resp: np.ndarray) -> np.ndarray:
    """Reference DisplayConvertDOG (ProgramCU.cu:3107-3119): gray =
    clamp(0.5 + 20*response), border forced to 0.5."""
    a = np.clip(0.5 + 20.0 * np.asarray(resp, np.float32), 0.0, 1.0)
    a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.5
    return a


def colorize_gradient(grad: np.ndarray) -> np.ndarray:
    """Reference DisplayConvertGRD (ProgramCU.cu:3138-3150): gray =
    clamp(5 * gradient magnitude), border 0."""
    a = np.clip(5.0 * np.asarray(grad, np.float32), 0.0, 1.0)
    a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
    return a


def colorize_keymap(resp: np.ndarray, key_valid: np.ndarray,
                    key_type: np.ndarray) -> np.ndarray:
    """Reference DisplayConvertKEY (ProgramCU.cu:3169-3230): response map
    as gray background, keypoint pixels solid red/green/blue by type
    (dark blob / bright blob / saddle)."""
    bg = colorize_response(resp)
    out = np.stack([bg] * 3, -1)
    valid = np.asarray(key_valid, bool)
    ftype = np.asarray(key_type)
    inside = np.zeros_like(valid)
    inside[1:-1, 1:-1] = True
    for t, color in TYPE_COLORS.items():
        m = valid & inside & (ftype == t)
        out[m] = color
    return out


def dump_views(image: np.ndarray, cfg=None, out_dir: str = "views",
               device="cuda") -> None:
    """Write the reference viewer's views for one image into out_dir:
    input, Gaussian levels, colorized response (DisplayConvertDOG),
    colorized gradient (DisplayConvertGRD), colorized typed keypoint maps
    (DisplayConvertKEY), and the feature-box overlay. DATA_ROT aliases
    DATA_GRAD in the reference display too (PyramidCU.cpp:1873), so the
    gradient view covers both. The pyramid and the detection run on
    `device` (the kernels on the card); the keypoint map is read only at
    the cells the detector marks valid, the only cells where its type is
    written."""
    import torch
    from PIL import Image

    from ..config import SiftConfig
    from ..detector import HessianSift
    from ..ops import hessian as hops
    from ..ops.resize import rgb_to_gray, to_float
    from ..pyramid import (_build_pyramid, _detect_octave, make_plan,
                           resolve_device)

    cfg = cfg or SiftConfig()
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)

    arr = to_float(torch.as_tensor(np.ascontiguousarray(image)).to(device))
    if arr.ndim == 3:
        arr = rgb_to_gray(arr)
    h, w = arr.shape
    plan = make_plan(h, w, cfg)
    p = cfg.scale_params()
    host = lambda t: t.cpu().numpy()

    _save_gray(os.path.join(out_dir, "0_input.png"), host(arr), False)

    octaves = _build_pyramid(arr.contiguous()[None], plan, cfg)
    for o, stack in enumerate(octaves[:2]):
        for l in range(stack.shape[1]):
            _save_gray(os.path.join(out_dir, f"1_gauss_o{o}_l{l}.png"),
                       host(stack[0, l]), False)
        maps, grad, rot = _detect_octave(stack, cfg)
        for li, kl in enumerate(p.key_levels):
            # reference DisplayConvertGRD mapping (ProgramCU.cu:3138-3150)
            _save_gray(os.path.join(out_dir, f"4_grad_o{o}_l{kl}.png"),
                       colorize_gradient(host(grad[0, li])),
                       normalize=False)
        # response maps via the hessian op
        norms = [(p.level_sigma(l2) ** 4)
                 for l2 in range(p.level_min, p.level_max + 1)]
        resp, _, _ = hops.hessian_response_and_gradient(stack[0], norms,
                                                        grad_levels=())
        for li, kl in enumerate(p.key_levels):
            # reference DisplayConvertDOG mapping (ProgramCU.cu:3107-3119)
            _save_gray(os.path.join(out_dir, f"3_resp_o{o}_l{kl}.png"),
                       colorize_response(host(resp[kl])),
                       normalize=False)
            # colorized keypoint map (DisplayConvertKEY,
            # ProgramCU.cu:3169-3230): typed detections over the response
            km = colorize_keymap(host(resp[kl]), host(maps.valid[0, li]),
                                 host(maps.ftype[0, li]))
            Image.fromarray((np.clip(km, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(out_dir, f"5_key_o{o}_l{kl}.png"))

    sift = HessianSift(cfg, device=device)
    feats = sift.run(np.asarray(image))
    kp = draw_keypoints(image, feats)
    Image.fromarray((np.clip(kp, 0, 1) * 255).astype(np.uint8)).save(
        os.path.join(out_dir, "6_keypoints.png"))
