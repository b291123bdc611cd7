"""Orientation histograms of the global table, one launch a batch.

Each valid keypoint's voting pixels read from the gradient magnitude and
angle maps (8 bytes a pixel: the windows the keypoints touch, not whole
planes); the table read and the orientations written (17 + 20 bytes a
row); 25 operations a voting pixel."""

OPS_PER_PIXEL = 25


def launches(ctx):
    if ctx["fixed_orientation"]:
        return {}
    px = ctx["ori_pixels"]
    return {"table": (8 * px + ctx["table_rows"] * (17 + 20),
                      OPS_PER_PIXEL * px)}
