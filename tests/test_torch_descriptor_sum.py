"""The descriptor kernel's summation, modelled on the CPU.

csrc/patch.cu descriptor_kernel sums a keypoint's 16 x 8 table in another
order than the plain version's matmul: the support's bounding box is cut,
in raster order, into rounds of 32 pixels; warp w of 4 takes the rounds w,
w + 4, ... and deals their contributing pixels, in order, round-robin to its
8 private tables; a pixel adds to the 2 x 2 cells around (floor cv, floor
cu) that exist, into bins ob and ob + 1, the product (ay * ax) * (share *
weight); the 4 x 8 tables are summed in order at the end.
A CUDA kernel cannot run here, so `_model_descriptor` repeats that in numpy
float32, sequentially per table entry (np.add.at adds in index order).

Tolerance: 2e-6 of the keypoint's largest entry against descriptor_plain -
the same float32 products, summed in another order, a few hundred to a few
thousand terms per entry. Slots that are not valid give zeros.

What this file checks is the design, not the kernel: that this order of
summation stays within the tolerance, and what the plain version counts (the
support's pixels, every rotation, the corners, slots that are not valid).
The model is kept in step with patch.cu by hand, so no edit of the CUDA
source can fail a test here; the kernel itself is held against
descriptor_plain on a GPU by tests/test_torch_cuda_kernels.py (marker `gpu`)
and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch.convert import level_maps_from_numpy
from hessgpu_tpu_torch.ops.cuda import patch
from hessgpu_tpu_torch.ops.descriptor import descriptor_window_size

ROW_PITCH, TAB_PITCH, GROUP, WARPS = 34, 140, 8, 4     # csrc/patch.cu
F = np.float32


def _model_one(grad, rot, kx, ky, sigma, theta, window_factor=3.0):
    """One keypoint's raw (16, 8) table the way the kernel sums it, and the
    number of contributing pixels."""
    H, W = grad.shape
    kx, ky, th = F(kx), F(ky), F(theta)
    spt = np.abs(F(sigma) * F(window_factor))
    t = torch.tensor(float(th), dtype=torch.float32)
    c, s = F(torch.cos(t).item()), F(torch.sin(t).item())
    crspt, srspt = F(c / spt), F(s / spt)
    pi = F(np.pi)
    anglef = F(th - F(2.0 * np.pi)) if th > pi else th
    R = F(F(F(2.5) * spt) * F(np.abs(c) + np.abs(s))) + F(2.0)
    ix0 = int(max(F(1.0), np.floor(F(kx - R))))
    ix1 = int(min(F(W) - F(2.0), np.ceil(F(kx + R))))
    iy0 = int(max(F(1.0), np.floor(F(ky - R))))
    iy1 = int(min(F(H) - F(2.0), np.ceil(F(ky + R))))
    tabs = np.zeros(WARPS * GROUP * TAB_PITCH, F)
    if ix1 < ix0 or iy1 < iy0:
        return np.zeros((16, 8), F), 0
    iy, ix = np.meshgrid(np.arange(iy0, iy1 + 1), np.arange(ix0, ix1 + 1),
                         indexing="ij")
    iy, ix = iy.reshape(-1), ix.reshape(-1)            # raster order
    warp = (np.arange(len(ix)) // 32) % WARPS          # whose round
    dx = (ix.astype(F) + F(0.5)) - kx
    dy = (iy.astype(F) + F(0.5)) - ky
    u = crspt * dx + srspt * dy
    v = crspt * dy - srspt * dx
    cu, cv = u + F(1.5), v + F(1.5)
    member = (cu > -1) & (cu < 4) & (cv > -1) & (cv < 4)
    iy, ix, u, v, cu, cv, warp = (a[member]
                                  for a in (iy, ix, u, v, cu, cv, warp))
    gauss_w = torch.exp(torch.from_numpy(F(-0.125) * (u * u + v * v))).numpy()
    tp = (anglef - rot[iy, ix]) * F(4.0 / np.pi)
    tp = np.where(tp < 0, tp + F(8.0), tp).astype(F)
    fo = np.floor(tp)
    ob = np.clip(fo.astype(np.int64), 0, 7)
    w2 = tp - fo
    w1 = F(1.0) - w2
    wgt = gauss_w * grad[iy, ix]
    v1, v2 = w1 * wgt, w2 * wgt
    fcu, fcv = np.floor(cu), np.floor(cv)
    cell = fcv.astype(np.int64) * ROW_PITCH + fcu.astype(np.int64) * 8
    # table of a pixel: its warp's, then round-robin in the warp's own order
    q = np.zeros(len(cu), np.int64)
    for w in range(WARPS):
        q[warp == w] = w * GROUP + np.arange(int((warp == w).sum())) % GROUP
    for dyc in (0, 1):
        for dxc in (0, 1):
            cxf, cyf = fcu + F(dxc), fcv + F(dyc)
            ok = (cxf >= 0) & (cxf <= 3) & (cyf >= 0) & (cyf <= 3)
            ay = np.maximum(F(0), F(1) - np.abs(cv - cyf))
            ax = np.maximum(F(0), F(1) - np.abs(cu - cxf))
            w = (ay * ax).astype(F)
            mine = q * TAB_PITCH + dyc * ROW_PITCH + dxc * 8
            np.add.at(tabs, (mine + cell + ob)[ok], (w * v1)[ok])
            np.add.at(tabs, (mine + cell + (ob + 1) % 8)[ok], (w * v2)[ok])
    out = np.zeros((16, 8), F)
    for cellno in range(16):
        at = (cellno // 4) * ROW_PITCH + (cellno % 4) * 8
        acc = tabs[at:at + 8].copy()
        for t in range(1, WARPS * GROUP):
            acc = acc + tabs[t * TAB_PITCH + at:t * TAB_PITCH + at + 8]
        out[cellno] = acc
    return out, int(member.sum())


def _model_descriptor(grads, rots, kx, ky, ks, kt, lid, valid):
    out = np.zeros((len(kx), 16, 8), F)
    support = np.zeros(len(kx), np.int64)
    for i in range(len(kx)):
        if valid[i]:
            out[i], support[i] = _model_one(grads[lid[i]], rots[lid[i]],
                                            kx[i], ky[i], ks[i], kt[i])
    return out, support


def _scene(seed, n):
    """Three levels of random gradient maps and n keypoints spread over
    them; theta sweeps 0..2pi; keypoints 0-3 sit at the four corners of
    their level, 4 has a tiny support, the last slot is not valid."""
    rng = np.random.RandomState(seed)
    levels = [(64, 96), (64, 96), (32, 48)]
    grads = [rng.rand(*s).astype(F) for s in levels]
    rots = [((rng.rand(*s) * 2 - 1) * np.pi).astype(F) for s in levels]
    lid = rng.randint(0, 3, n).astype(np.int32)
    h = np.array([levels[l][0] for l in lid])
    w = np.array([levels[l][1] for l in lid])
    kx = (rng.rand(n) * (w - 2) + 1).astype(F)
    ky = (rng.rand(n) * (h - 2) + 1).astype(F)
    ks = (1.6 + 1.6 * rng.rand(n)).astype(F)
    kt = np.linspace(0.0, 2 * np.pi, n, endpoint=False).astype(F)
    kt[5:9] = [np.pi, np.pi / 2, np.nextafter(F(np.pi), F(4)), 5.9]
    kx[:4] = [0.4, w[1] - 0.6, 0.4, w[3] - 0.6]
    ky[:4] = [0.3, 0.3, h[2] - 0.7, h[3] - 0.7]
    ks[4] = 0.2
    valid = np.ones(n, bool)
    valid[-1] = False
    return grads, rots, kx, ky, ks, kt, lid, valid


@pytest.mark.parametrize("seed,n", [(3, 24), (4, 40)], ids=["seed3", "seed4"])
def test_kernel_summation_model_matches_plain(seed, n):
    grads, rots, kx, ky, ks, kt, lid, valid = _scene(seed, n)
    got, support = _model_descriptor(grads, rots, kx, ky, ks, kt, lid, valid)
    maps = level_maps_from_numpy(grads, rots)
    row = lambda a: torch.from_numpy(a)[None]
    wsize = descriptor_window_size(float(ks.max()))
    want = patch.descriptor_plain(row(kx), row(ky), row(ks), row(kt),
                                  row(valid), row(lid), maps, wsize)[0].numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert scale[valid].min() > 0
    assert (np.abs(got - want)[valid] / scale[valid]).max() <= 2e-6
    assert not got[~valid].any() and not want[~valid].any()
    assert support[valid].min() > 0 and support[4] < 30   # tiny and corner
    assert support.max() > 1000                           # and large ones


def test_kernel_summation_model_counts_the_plain_versions_pixels():
    """The bounding box the kernel walks holds every pixel the plain version
    counts: the two agree on the number of contributing pixels."""
    from hessgpu_tpu_torch.ops.descriptor import compute_descriptors_flat
    grads, rots, kx, ky, ks, kt, lid, valid = _scene(5, 32)
    _, support = _model_descriptor(grads, rots, kx, ky, ks, kt, lid, valid)
    maps = level_maps_from_numpy(grads, rots)
    row = lambda a: torch.from_numpy(a)[None]
    _, want = compute_descriptors_flat(
        row(kx), row(ky), row(ks), row(kt), row(valid), row(lid), maps,
        descriptor_window_size(float(ks.max())))
    np.testing.assert_array_equal(support, want[0].numpy())


@pytest.mark.parametrize("theta", [0.0, 0.7853982, 1.5707964, 3.1415927,
                                   4.712389, 6.2831855 - 1e-3],
                         ids=["0", "pi/4", "pi/2", "pi", "3pi/2", "2pi-"])
def test_model_matches_plain_at_every_rotation(theta):
    """Axis-aligned and diagonal frames, the wrap of the angle at pi, for a
    keypoint in the middle of its level and one at a corner."""
    grads, rots, kx, ky, ks, kt, lid, valid = _scene(6, 12)
    kt[:] = theta
    got, support = _model_descriptor(grads, rots, kx, ky, ks, kt, lid, valid)
    maps = level_maps_from_numpy(grads, rots)
    row = lambda a: torch.from_numpy(a)[None]
    want = patch.descriptor_plain(
        row(kx), row(ky), row(ks), row(kt), row(valid), row(lid), maps,
        descriptor_window_size(float(ks.max())))[0].numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want)[valid] / scale[valid]).max() <= 2e-6
    assert support[0] > 0 and got[0].max() > 0           # the corner keypoint
