"""Seeded blob textures, made on the device: the traffic's frame content.

The same procedure as the program's `sfm.synthetic.make_texture` (a field
of 0.5; blobs with centres uniform over the frame, sigma = 1.2 + 7 u^2,
target intensity u, each composited over its 3-sigma disk in order as
t <- (1 - a) t + a v with a = exp(-d^2 / 2 sigma^2); then 0.02 u of noise
and a clip to [0, 1]), vectorised: no loop over blobs on the host.

Blobs are composited a chunk at a time, in order. Within a chunk the
result at a pixel is t * prod(1 - a_i) + sum_i a_i v_i prod_{j > i}
(1 - a_j), the blobs i touching it in blob order. The products are sums of
logarithms held in int64 fixed point, the weighted sum too, so that every
sum is exact and the frames are the same bit for bit from run to run,
whatever order the device adds in. The random numbers come from one
torch.Generator on the device, seeded by the run's seed.
"""

from __future__ import annotations

import math

import torch

SIGMA_MIN, SIGMA_SPAN = 1.2, 7.0
NOISE = 0.02
LOG_SCALE = float(2 ** 32)       # fixed point of the log-products
SUM_SCALE = float(2 ** 40)       # fixed point of the weighted sums
ALPHA_MAX = 1.0 - 2.0 ** -20     # keeps log(1 - a) finite at a disk centre
CHUNK_ENTRIES = 1 << 25          # (blob, box pixel) candidates per chunk


def blob_count(height: int, width: int, density: float) -> int:
    return max(1, int(round(density * height * width)))


def blob_frames(n: int, height: int, width: int, density: float, seed: int,
                device) -> torch.Tensor:
    """(n, height, width) float32 frames in [0, 1] on `device`, a function
    of (n, height, width, density, seed) alone."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    nb = blob_count(height, width, density)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float64)

    cx = rand(n, nb) * width
    cy = rand(n, nb) * height
    sigma = SIGMA_MIN + rand(n, nb) ** 2 * SIGMA_SPAN
    val = rand(n, nb)
    noise = torch.rand((n, height, width), generator=gen, device=device,
                       dtype=torch.float32)

    radius = int(math.ceil(3.0 * (SIGMA_MIN + SIGMA_SPAN))) + 1
    box = 2 * radius + 1
    per_chunk = max(1, CHUNK_ENTRIES // (n * box * box))
    t = torch.full((n * height * width,), 0.5, dtype=torch.float64,
                   device=device)
    ar = torch.arange(box, device=device, dtype=torch.int64) - radius
    frame0 = (torch.arange(n, device=device, dtype=torch.int64)
              * (height * width))[:, None, None, None]
    for b0 in range(0, nb, per_chunk):
        sl = slice(b0, min(nb, b0 + per_chunk))
        bx, by, bs, bv = cx[:, sl], cy[:, sl], sigma[:, sl], val[:, sl]
        # the box of pixels around each blob's centre: (n, k, box, box)
        px = torch.floor(bx).to(torch.int64)[..., None, None] + ar[None, :]
        py = torch.floor(by).to(torch.int64)[..., None, None] + ar[:, None]
        d2 = ((px.to(torch.float64) - bx[..., None, None]) ** 2
              + (py.to(torch.float64) - by[..., None, None]) ** 2)
        r2 = (3.0 * bs[..., None, None]) ** 2
        keep = ((d2 < r2) & (px >= 0) & (px < width) & (py >= 0)
                & (py < height))
        pix = (frame0 + py * width + px)[keep]           # blob-major order
        alpha = torch.exp(-0.5 * d2 / (bs[..., None, None] ** 2))
        alpha = alpha.clamp(max=ALPHA_MAX)[keep]
        av = (alpha * bv[..., None, None].expand_as(d2)[keep])
        logq = torch.round(torch.log1p(-alpha) * LOG_SCALE).to(torch.int64)
        # per pixel, blobs in their order: a stable sort by pixel keeps it
        pix, order = torch.sort(pix, stable=True)
        logq, av = logq[order], av[order]
        total = torch.zeros_like(t, dtype=torch.int64).index_add_(0, pix, logq)
        incl = torch.cumsum(logq, 0)
        first = torch.ones_like(pix, dtype=torch.bool)
        first[1:] = pix[1:] != pix[:-1]
        start = torch.cummax(torch.where(
            first, torch.arange(pix.numel(), device=device), 0), 0).values
        incl = incl - (incl[start] - logq[start])         # within the pixel
        after = total[pix] - incl                         # blobs after this
        w = av * torch.exp(after.to(torch.float64) / LOG_SCALE)
        acc = torch.zeros_like(t, dtype=torch.int64).index_add_(
            0, pix, torch.round(w * SUM_SCALE).to(torch.int64))
        t = t * torch.exp(total.to(torch.float64) / LOG_SCALE) \
            + acc.to(torch.float64) / SUM_SCALE
    frames = t.to(torch.float32).reshape(n, height, width)
    return (frames + NOISE * noise).clamp_(0.0, 1.0)
