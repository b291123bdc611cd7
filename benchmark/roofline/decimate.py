"""The decimation of level level_ds into the next octave's base: the
chain's epilogue on the main path (the kept pixels are on chip; it writes
them, 4 bytes a pixel of the next octave)."""


def launches(ctx):
    shapes = ctx["octave_shapes"]
    return {f"octave{o}": (4 * ctx["batch"] * h * w, 0)
            for o, (h, w) in enumerate(shapes[1:])}
