"""The initial blur: one launch over the batch's frames.

Reads each frame once and writes its blurred plane once (8 bytes a pixel);
two passes of the tap vector, a multiply and an add a tap (4 operations a
tap and pixel)."""


def launches(ctx):
    if ctx["blur_taps"] == 0:
        return {}
    n = ctx["batch"] * ctx["octave_shapes"][0][0] * ctx["octave_shapes"][0][1]
    return {"initial": (8 * n, 4 * ctx["blur_taps"] * n)}
