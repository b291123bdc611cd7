"""Descriptors of the expanded table, one launch a batch.

Each described row's contributing pixels read from the gradient maps (8
bytes a pixel: the windows the rows touch); the table read and the raw
4x4x8 descriptor written (21 + 512 bytes a row); 75 operations a
contributing pixel."""

OPS_PER_PIXEL = 75


def launches(ctx):
    if not ctx["compute_descriptors"]:
        return {}
    px = ctx["desc_pixels"]
    return {"table": (8 * px + ctx["desc_table_rows"] * (21 + 512),
                      OPS_PER_PIXEL * px)}
