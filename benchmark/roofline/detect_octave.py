"""Fused detection of each octave, one launch an octave.

Reads the L Gaussian planes (4 L bytes a pixel); writes per key level the
valid byte and the gradient magnitude and angle (9 bytes a pixel and key
level) and the payload (response, dx, dy, ds, ftype: 20 bytes) at the valid
cells these inputs give. About 13 operations a response plane and pixel, 30
a key level and pixel (threshold, gradient, angle), 170 a valid cell (NMS,
edge test, 3x3 solve, typing)."""


def launches(ctx):
    L, NK = ctx["num_levels"], ctx["key_levels"]
    out = {}
    for o, (h, w) in enumerate(ctx["octave_shapes"]):
        n = ctx["batch"] * h * w
        v = ctx["valid_cells"][o]
        out[f"octave{o}"] = (n * (4 * L + 9 * NK) + 20 * v,
                             n * (13 * L + 30 * NK) + 170 * v)
    return out
