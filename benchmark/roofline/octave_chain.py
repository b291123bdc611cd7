"""The Gaussian chain of each octave, one launch an octave, in place.

Reads level 0 once and writes the L - 1 levels after it (4 L bytes a
pixel); two passes of each transition's taps, a multiply and an add a tap
(4 operations a tap and pixel)."""


def launches(ctx):
    L = ctx["num_levels"]
    taps = sum(ctx["chain_taps"])
    out = {}
    for o, (h, w) in enumerate(ctx["octave_shapes"]):
        n = ctx["batch"] * h * w
        out[f"octave{o}"] = (4 * n * L, 4 * taps * n)
    return out
