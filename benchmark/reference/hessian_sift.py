"""Plain reference of the detect + describe pipeline, in PyTorch alone.

A frozen copy of the port's plain stages (its `*_plain` routes: separable
Gaussian pyramid by chained clamp-to-edge blurs, det-of-Hessian or DoG
response, 3x3x3 NMS, edge test, subpixel solve, typing, the row-capped
per-octave compaction, the global table, 36-bin orientation histograms,
multi-orientation expansion, 4x4x8 descriptors with L2 / 0.2 / L2
normalization, image coordinates). It imports nothing of the program and
of JAX: it works every table out again from the frames it is given.

Every expression keeps the order of operations of the port's plain stages,
which the port's CUDA kernels equal bit for bit on the dense stages; the
per-keypoint stages (orientation, descriptor) agree to rounding. TF32 is
turned off around the one matrix product (the descriptor's cell sums).

`plane_dtype=torch.bfloat16` is the comparison's control: every Gaussian
plane (the input too) is rounded to bfloat16 as it is made, the rest of the
arithmetic stays float32 - a pyramid stored in the precision below the
configuration's float32.

run(frames, settings) returns (Table, Work): the tables of a (B, H, W)
float32 batch and the work these inputs need (valid cells per octave,
the pixels the orientation and descriptor windows read), which the
roofline counts take.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

TWO_PI = 6.283185307179586
BINS_PER_RADIAN = 36.0 / TWO_PI
CHUNK = 256                      # keypoints per gathered batch of windows
KERNEL_MAX_WIDTH, KERNEL_MIN_WIDTH = 33, 5
ROW_CAP_FLOOR = 32
TYPE_DARK_BLOB, TYPE_BRIGHT_BLOB, TYPE_SADDLE, TYPE_NONE = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# settings and the static plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Settings:
    """The detector settings the reference follows (the names of the
    program's SiftConfig fields; unknown names are refused)."""
    detector: str = "hessian"
    num_scales: int = 3
    threshold: Optional[float] = None
    edge_threshold: float = 10.0
    filter_width_factor: float = 4.0
    min_dim: int = 16
    num_octaves: int = -1
    subpixel: bool = True
    max_orientations: int = 2
    fixed_orientation: bool = False
    orientation_window_factor: float = 2.0
    orientation_gaussian_factor: float = 1.5
    multi_orientation_threshold: float = 0.8
    descriptor_window_factor: float = 3.0
    half_sift: bool = False
    compute_descriptors: bool = True
    normalized_sift: bool = True
    max_feature_percent: float = 0.005
    max_level_features: int = 4096
    global_feature_cap: int = 2048
    expansion_factor: float = 1.5
    lowe_origin: bool = False
    darkness_adaption: bool = False

    @classmethod
    def from_fields(cls, fields: dict) -> "Settings":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(fields) - known)
        if unknown:
            raise ValueError(f"the reference does not follow {unknown}")
        return cls(**fields)

    @property
    def thr(self) -> float:
        return self.threshold if self.threshold is not None \
            else 0.02 / self.num_scales

    @property
    def level_min(self) -> int:
        return 0 if self.detector == "hessian" else -1

    @property
    def level_max(self) -> int:
        return self.num_scales + 1

    @property
    def num_levels(self) -> int:
        return self.level_max - self.level_min + 1

    @property
    def level_ds(self) -> int:
        return min(self.level_min + self.num_scales, self.level_max)

    @property
    def sigmak(self) -> float:
        return 2.0 ** (1.0 / self.num_scales)

    @property
    def base_sigma(self) -> float:
        return 1.6 if self.detector == "hessian" else 1.6 * self.sigmak

    def level_sigma(self, level: int) -> float:
        return self.base_sigma * (2.0 ** (level / self.num_scales))

    def initial_blur_sigma(self) -> float:
        sa = self.base_sigma * (2.0 ** (self.level_min / self.num_scales))
        sb = 0.5
        return math.sqrt(sa * sa - sb * sb) if sa > sb + 1e-3 else 0.0

    def incremental_sigmas(self) -> List[float]:
        k = self.sigmak
        if self.detector == "hessian":
            d0 = self.base_sigma * math.sqrt(k * k - 1.0)
            return [d0 * (k ** i) for i in range(self.num_levels - 1)]
        d0 = self.base_sigma * math.sqrt(1.0 - 1.0 / (k * k))
        lo = self.level_min + 1
        return [d0 * (k ** (i + lo)) for i in range(self.num_levels - 1)]

    def restart_sigma(self) -> float:
        k = self.sigmak
        sa = self.base_sigma * (k ** self.level_min)
        sb = self.base_sigma * (k ** (self.level_ds - self.num_scales))
        return math.sqrt(sa * sa - sb * sb) if sa > sb + 1e-3 else 0.0

    @property
    def key_levels(self) -> List[int]:
        return list(range(1, self.num_scales + 1))

    def key_level_sigma(self, key_level: int) -> float:
        return self.level_sigma(key_level + self.level_min)


def gaussian_taps(sigma: float, factor: float) -> List[float]:
    sz = int(math.ceil(factor * sigma - 0.5))
    width = min(max(2 * sz + 1, KERNEL_MIN_WIDTH), KERNEL_MAX_WIDTH)
    sz = width // 2
    rv = 1.0 / (sigma * sigma)
    taps = [math.exp(-0.5 * i * i * rv) for i in range(-sz, sz + 1)]
    ksum = sum(taps)
    return [t / ksum for t in taps]


class Plan(NamedTuple):
    height: int
    width: int
    octave_shapes: tuple
    level_caps: tuple        # one per octave (every key level of it alike)


def make_plan(height: int, width: int, s: Settings) -> Plan:
    noct = max(int(math.floor(math.log(min(height, width) * 2.0 / s.min_dim)
                              / math.log(2.0))), 1)
    if s.num_octaves > 0:
        noct = min(noct, s.num_octaves)
    shapes, h, w = [], height, width
    for _ in range(noct):
        shapes.append((h, w))
        h, w = h // 2, w // 2
    caps = []
    for (h, w) in shapes:
        cap = max(32, min(int(h * w * s.max_feature_percent),
                          s.max_level_features))
        caps.append((cap + 7) // 8 * 8)
    return Plan(height, width, tuple(shapes), tuple(caps))


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------

def _conv1d_clamped(x, taps, axis):
    t = np.asarray(taps, dtype=np.float32)
    r = len(t) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    xp = x.index_select(axis, idx)
    out = float(t[0]) * xp.narrow(axis, 0, n)
    for k in range(1, len(t)):
        out = out + float(t[k]) * xp.narrow(axis, k, n)
    return out


def _blur(x, taps):
    x = _conv1d_clamped(x, taps, x.ndim - 1)
    return _conv1d_clamped(x, taps, x.ndim - 2)


def build_pyramid(imgs, plan: Plan, s: Settings, plane_dtype=torch.float32):
    """One (B, L, h, w) Gaussian stack per octave."""
    store = (lambda a: a) if plane_dtype == torch.float32 \
        else (lambda a: a.to(plane_dtype).to(torch.float32))
    taps_list = [gaussian_taps(sg, s.filter_width_factor) if sg > 0 else ()
                 for sg in s.incremental_sigmas()]
    lds = s.level_ds - s.level_min
    sigma0 = s.initial_blur_sigma()
    base = store(imgs)
    if sigma0 > 0:
        base = store(_blur(base, gaussian_taps(sigma0, s.filter_width_factor)))
    octaves = []
    for o in range(len(plan.octave_shapes)):
        if o > 0:
            oh, ow = plan.octave_shapes[o]
            base = octaves[-1][:, lds][..., ::2, ::2].contiguous()
            base = base[..., :oh, :ow].contiguous()
            rs = s.restart_sigma()
            if rs > 0:
                base = store(_blur(base, gaussian_taps(rs,
                                                       s.filter_width_factor)))
        levels = [base]
        for tp in taps_list:
            levels.append(store(_blur(levels[-1], tp)) if len(tp)
                          else levels[-1])
        octaves.append(torch.stack(levels, dim=-3))
    return octaves


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def f32(v: float) -> float:
    return float(np.float32(v))


def _shift(x, dy: int, dx: int):
    if dy:
        h = x.shape[-2]
        rows = (torch.arange(h, device=x.device) + dy).clamp_(0, h - 1)
        x = x.index_select(-2, rows)
    if dx:
        w = x.shape[-1]
        cols = (torch.arange(w, device=x.device) + dx).clamp_(0, w - 1)
        x = x.index_select(-1, cols)
    return x


def _grad_rot(g):
    dx = _shift(g, 0, 1) - _shift(g, 0, -1)
    dy = _shift(g, 1, 0) - _shift(g, -1, 0)
    mag = 0.5 * torch.sqrt(dx * dx + dy * dy)
    rot = torch.where(mag == 0.0, torch.zeros_like(mag), torch.atan2(dy, dx))
    return mag, rot


def _hessian_response(gauss, norms, grad_levels):
    v12, v32 = _shift(gauss, -1, 0), _shift(gauss, 1, 0)
    v21, v23 = _shift(gauss, 0, -1), _shift(gauss, 0, 1)
    v11, v13 = _shift(v12, 0, -1), _shift(v12, 0, 1)
    v31, v33 = _shift(v32, 0, -1), _shift(v32, 0, 1)
    lxx = v21 - 2.0 * gauss + v23
    lyy = v12 - 2.0 * gauss + v32
    lxy = (v13 - v11 + v31 - v33) * 0.25
    norm = torch.tensor([float(n) for n in norms], dtype=gauss.dtype,
                        device=gauss.device).reshape(-1, 1, 1)
    response = (lxx * lyy - lxy * lxy) * norm
    grad = torch.zeros_like(gauss)
    rot = torch.zeros_like(gauss)
    levels = sorted({int(l) for l in grad_levels})
    mag, ang = _grad_rot(gauss[..., levels, :, :])
    grad[..., levels, :, :] = mag
    rot[..., levels, :, :] = ang
    return response, grad, rot


class KeyMaps(NamedTuple):
    valid: torch.Tensor
    response: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    ds: torch.Tensor
    ftype: torch.Tensor


def _solve3(a0, a1, a2):
    a, b, c, r0 = a0
    d, e, r1 = a1[1], a1[2], a1[3]
    f, r2 = a2[2], a2[3]
    C00 = d * f - e * e
    C01 = c * e - b * f
    C02 = b * e - c * d
    det = a * C00 + b * C01 + c * C02
    ok = det.abs() >= f32(1e-30)
    rdet = torch.reciprocal(torch.where(ok, det, torch.ones_like(det)))
    s0, s1, s2 = r0 * rdet, r1 * rdet, r2 * rdet
    dx = C00 * s0 + C01 * s1 + C02 * s2
    C11 = a * f - c * c
    C12 = b * c - a * e
    dy = C01 * s0 + C11 * s1 + C12 * s2
    C22 = a * d - b * b
    ds = C02 * s0 + C12 * s1 + C22 * s2
    zero = torch.zeros_like(ds)
    return ok, torch.where(ok, dx, zero), torch.where(ok, dy, zero), \
        torch.where(ok, ds, zero)


def _detect_level(resp_prev, v, resp_next, gauss_cur, s: Settings,
                  hessian: bool) -> KeyMaps:
    h, w = v.shape[-2:]
    if s.darkness_adaption:
        thr = f32(s.thr) * torch.clamp(2.0 * gauss_cur + f32(0.1), max=1.0)
        thr0 = f32(0.8) * thr if s.subpixel else thr
    else:
        thr = f32(s.thr)
        thr0 = f32(0.8 * s.thr) if s.subpixel else thr

    def ring(x):
        top, bot = _shift(x, -1, 0), _shift(x, 1, 0)
        return [_shift(top, 0, -1), top, _shift(top, 0, 1),
                _shift(x, 0, -1), _shift(x, 0, 1),
                _shift(bot, 0, -1), bot, _shift(bot, 0, 1)]

    tl, up, tr, left, right, bl, down, br = ring(v)
    rest = [up, down, tl, tr, bl, br]
    rest += ring(resp_prev) + [resp_prev]
    rest += ring(resp_next) + [resp_next]
    rest_max = rest_min = rest[0]
    for x in rest[1:]:
        rest_max = torch.maximum(rest_max, x)
        rest_min = torch.minimum(rest_min, x)
    is_max = (v > torch.maximum(left, right)) & (v >= rest_max)
    is_min = (v < torch.minimum(left, right)) & (v <= rest_min)
    if hessian:
        is_max = is_max & (v >= 0)
        is_min = is_min & (v <= 0)
    extremum = (v.abs() > thr0) & (is_max | is_min)

    fx = 0.5 * (right - left)
    fy = 0.5 * (down - up)
    vx2 = 2.0 * v
    fxx = left + right - vx2
    fyy = up + down - vx2
    fxy = 0.25 * (br + tl - bl - tr)
    det2 = fxx * fyy - fxy * fxy
    trc = fxx + fyy
    te = f32((s.edge_threshold + 1.0) ** 2 / s.edge_threshold)
    extremum = extremum & (det2 > 0) & (trc * trc <= te * det2)

    if s.subpixel:
        cn, cp = resp_next, resp_prev
        fs = 0.5 * (cn - cp)
        fss = cn + cp - vx2
        fxs = 0.25 * (_shift(cn, 0, 1) + _shift(cp, 0, -1)
                      - _shift(cn, 0, -1) - _shift(cp, 0, 1))
        fys = 0.25 * (_shift(cn, 1, 0) + _shift(cp, -1, 0)
                      - _shift(cn, -1, 0) - _shift(cp, 1, 0))
        ok, dx, dy, ds = _solve3((fxx, fxy, fxs, -fx), (fxy, fyy, fys, -fy),
                                 (fxs, fys, fss, -fs))
        refined = v + 0.5 * (dx * fx + dy * fy + ds * fs)
        response = torch.where(ok, refined, v)
        passed = (response.abs() > thr) & (ds.abs() < 1.0) \
            & (dx.abs() < 1.0) & (dy.abs() < 1.0)
        extremum = extremum & (~ok | passed)
    else:
        dx = dy = ds = torch.zeros_like(v)
        response = v

    rows = torch.arange(h, device=v.device).reshape(-1, 1)
    cols = torch.arange(w, device=v.device).reshape(1, -1)
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    valid = extremum & interior
    if hessian:
        g_lxx = (_shift(gauss_cur, 0, -1) - 2.0 * gauss_cur
                 + _shift(gauss_cur, 0, 1))
        ftype = torch.where(g_lxx > 0, TYPE_DARK_BLOB, TYPE_BRIGHT_BLOB)
        ftype = torch.where(response < 0, TYPE_SADDLE, ftype)
    else:
        ftype = torch.where(is_max, TYPE_BRIGHT_BLOB, TYPE_DARK_BLOB)
    ftype = torch.where(valid, ftype, TYPE_NONE).to(torch.int32)
    response = response.to(torch.float16).to(torch.float32)
    response = torch.where(valid, response, torch.zeros_like(response))
    return KeyMaps(valid, response, dx, dy, ds, ftype)


def detect_octave(gauss, s: Settings):
    """KeyMaps with (B, NK, h, w) leaves and the key levels' gradient
    magnitude and angle maps (B, NK, h, w)."""
    kl = s.key_levels
    if s.detector == "hessian":
        norms = [s.level_sigma(l) ** 4
                 for l in range(s.level_min, s.level_max + 1)]
        resp, grad, rot = _hessian_response(gauss, norms, kl)
    else:
        cur = gauss[..., 1:, :, :]
        resp = cur - gauss[..., :-1, :, :]
        grad, rot = _grad_rot(cur)
        grad = torch.cat([grad[:, :1], grad], dim=1)
        rot = torch.cat([rot[:, :1], rot], dim=1)
    maps = [_detect_level(resp[:, k - 1], resp[:, k], resp[:, k + 1],
                          gauss[:, k], s, s.detector == "hessian")
            for k in kl]
    stacked = KeyMaps(*(torch.stack(xs, dim=1) for xs in zip(*maps)))
    return stacked, grad[:, kl].contiguous(), rot[:, kl].contiguous()


# ---------------------------------------------------------------------------
# compaction and the global table
# ---------------------------------------------------------------------------

class Table(NamedTuple):
    """(B, N) rows; level coordinates inside the pipeline, image
    coordinates in run()'s result."""
    x: torch.Tensor
    y: torch.Tensor
    sigma: torch.Tensor
    theta: torch.Tensor
    response: torch.Tensor
    ftype: torch.Tensor
    level: torch.Tensor
    valid: torch.Tensor
    desc: Optional[torch.Tensor] = None


def _first_slots(pos, capacity: int):
    n = pos.shape[-1]
    count = pos[..., -1].clamp(max=capacity)
    want = torch.arange(1, capacity + 1, dtype=torch.int32, device=pos.device)
    src = torch.searchsorted(
        pos, want.expand(pos.shape[:-1] + (capacity,)).contiguous())
    return src.clamp_(max=n - 1), want <= count[..., None]


def compact_sorted(valid, values, capacity: int):
    src, slot_valid = _first_slots(
        torch.cumsum(valid, dim=-1, dtype=torch.int32), capacity)
    outs = []
    for val in values:
        o = torch.gather(val, -1, src)
        outs.append(torch.where(slot_valid, o, torch.zeros_like(o)))
    return outs, slot_valid


def _row_cap(w: int) -> int:
    return max(ROW_CAP_FLOOR, min(256, w // 32))


def compact_octave(maps: KeyMaps, sigmas, sigma_step: float, capacity: int):
    """The leftmost min(w, row cap) valid cells of each row, then the first
    `capacity` in raster order, per key level: (B, NK, capacity) fields."""
    h, w = maps.valid.shape[-2:]
    flat = lambda a: a.reshape(a.shape[:-2] + (h * w,))
    rank = torch.cumsum(maps.valid, dim=-1, dtype=torch.int32)
    rank.clamp_(max=min(w, _row_cap(w)))
    kept = rank[..., -1]
    before = torch.cumsum(kept, dim=-1, dtype=torch.int32) - kept
    src, sv = _first_slots(flat(rank.add_(before[..., None])), capacity)
    take = lambda a: torch.gather(flat(a), -1, src)
    dx, dy, ds = take(maps.dx), take(maps.dy), take(maps.ds)
    row = torch.div(src, w, rounding_mode="floor")
    x = ((src - row * w) + 0.5) + dx
    y = (row + 0.5) + dy
    sig = sigmas[:, None] * torch.pow(f32(sigma_step), ds)
    fields = torch.where(sv, torch.stack([x, y, sig, take(maps.response)]), 0)
    return (fields[0], fields[1], fields[2], fields[3],
            torch.where(sv, take(maps.ftype), 0), sv)


def _expand(t: Table, thetas, ovalid, cap: int) -> Table:
    mask = (ovalid & t.valid[..., None]).flatten(-2)
    rep = lambda a: a.repeat_interleave(4, dim=-1)
    lidft = (t.level << 2) | (t.ftype & 3)
    (x, y, sg, th, r, lf), sv = compact_sorted(
        mask, [rep(t.x), rep(t.y), rep(t.sigma), thetas.flatten(-2),
               rep(t.response), rep(lidft)], cap)
    return Table(x, y, sg, th, r, torch.where(sv, lf & 3, 0), lf >> 2, sv)


# ---------------------------------------------------------------------------
# per-keypoint stages
# ---------------------------------------------------------------------------

def _flat_levels(grads, rots):
    """Flat gradient buffers of every key level and their geometry columns
    (base, bstride, height, width) as int64 tensors, level-id order."""
    dev = grads[0].device
    cols, base = [], 0
    for g in grads:
        B, nk, h, w = (int(v) for v in g.shape)
        for k in range(nk):
            cols.append((base + k * h * w, nk * h * w, h, w))
        base += B * nk * h * w
    c = torch.tensor(cols, dtype=torch.int64, device=dev)
    return (torch.cat([g.reshape(-1) for g in grads]),
            torch.cat([r.reshape(-1) for r in rots]),
            c[:, 0], c[:, 1], c[:, 2], c[:, 3])


def _gather(tables, level, flat, wsize: int, sel):
    G = level.shape[-1]
    fgrad, frot, lbase, lbstride, lh, lw = flat
    vals = [t.reshape(-1)[sel] for t in tables]
    lid = level.reshape(-1)[sel].to(torch.int64)
    b = torch.div(sel, G, rounding_mode="floor")
    base = lbase[lid] + b * lbstride[lid]
    h, w = lh[lid], lw[lid]
    r = (wsize - 1) // 2
    y0 = torch.floor(vals[1]).to(torch.int64) - r
    x0 = torch.floor(vals[0]).to(torch.int64) - r
    ar = torch.arange(wsize, device=sel.device)
    ys = torch.minimum((y0[:, None] + ar).clamp_(min=0), (h - 1)[:, None])
    xs = torch.minimum((x0[:, None] + ar).clamp_(min=0), (w - 1)[:, None])
    idx = (base[:, None, None] + ys[:, :, None] * w[:, None, None]
           + xs[:, None, :])
    f = torch.float32
    return (vals, fgrad[idx], frot[idx], x0.to(f), y0.to(f), w.to(f),
            h.to(f))


def _valid_chunks(valid, chunk: int):
    idx = torch.nonzero(valid.reshape(-1))[:, 0]
    return idx.split(chunk) if idx.numel() else ()


def _const(ref, value: float):
    return torch.full((), value, dtype=ref.dtype, device=ref.device)


def _histogram36(kx, ky, sigma, gwin, rwin, x0, y0, width, height, gf, wf):
    wsize = gwin.shape[-1]
    gsigma = sigma * gf
    win = sigma.abs() * (gf * wf)
    dist_threshold = (win * win + 0.5)[:, None, None]
    factor = (-0.5 / (gsigma * gsigma))[:, None, None]
    ar = torch.arange(wsize, dtype=torch.float32, device=kx.device)
    iy = y0[:, None, None] + ar[None, :, None]
    ix = x0[:, None, None] + ar[None, None, :]
    dx = (ix + 0.5) - kx[:, None, None]
    dy = (iy + 0.5) - ky[:, None, None]
    sq = dx * dx + dy * dy
    lo = lambda k: torch.floor(k - win).clamp(min=1.0)[:, None, None]
    hi = lambda k, dim: torch.minimum(dim - 2.0,
                                      torch.floor(k + win))[:, None, None]
    in_range = ((ix >= lo(kx)) & (ix <= hi(kx, width))
                & (iy >= lo(ky)) & (iy <= hi(ky, height))
                & (sq < dist_threshold))
    obin = torch.floor(rwin * BINS_PER_RADIAN).to(torch.int32)
    obin = torch.where(obin < 0, obin + 36, obin).clamp_(0, 35)
    weight = torch.where(in_range, gwin * torch.exp(sq * factor), 0.0)
    zero = torch.zeros_like(weight)
    votes = torch.stack([torch.where(obin == b, weight, zero).sum(dim=(1, 2))
                         for b in range(36)], dim=1)
    return votes, in_range.sum(dim=(1, 2), dtype=torch.int64)


def _smooth6(votes):
    three = _const(votes, 3.0)
    for _ in range(6):
        votes = ((torch.roll(votes, 1, -1) + votes)
                 + torch.roll(votes, -1, -1)) / three
    return votes


def _peaks(votes, single: bool, peak_threshold: float, max_peaks: int):
    if single or max_peaks <= 1:
        imax = torch.argmax(votes, dim=-1, keepdim=True)
        vmax = torch.gather(votes, -1, imax)
        pre = torch.gather(votes, -1, (imax + 35) % 36)
        nxt = torch.gather(votes, -1, (imax + 1) % 36)
        off = 0.5 * (nxt - pre) / (vmax + vmax - nxt - pre)
        theta = (imax.to(votes.dtype) + 0.5 + off) / _const(votes,
                                                            BINS_PER_RADIAN)
        thetas = torch.zeros(votes.shape[:-1] + (4,), dtype=votes.dtype,
                             device=votes.device)
        thetas[..., 0] = theta[..., 0]
        valid = torch.zeros_like(thetas, dtype=torch.bool)
        valid[..., 0] = True
        return thetas, valid
    max_peaks = min(max_peaks, 4)
    pre = torch.roll(votes, 1, -1)
    nxt = torch.roll(votes, -1, -1)
    vmax = votes.max(dim=-1, keepdim=True).values
    is_peak = (votes > peak_threshold * vmax) & (votes > pre) & (votes > nxt)
    score = torch.where(is_peak, votes, -torch.inf)
    top_v, top_i = torch.sort(score, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[..., :4], top_i[..., :4]
    valid = torch.isfinite(top_v) & (
        torch.arange(4, device=votes.device) < max_peaks)
    prei = torch.gather(pre, -1, top_i)
    nxti = torch.gather(nxt, -1, top_i)
    vi = torch.gather(votes, -1, top_i)
    di = 0.5 * (nxti - prei) / (vi + vi - nxti - prei)
    rot = top_i.to(votes.dtype) + di + 0.5
    frac = rot / _const(votes, 36.0)
    frac = torch.where(frac < 0, frac + 1.0, frac)
    thetas = torch.floor(frac * 255.0) * (TWO_PI / 255.0)
    return torch.where(valid, thetas, 0.0), valid


def orientations(t: Table, flat, s: Settings, owin: int, single: bool):
    """(thetas (B, G, 4), valid (B, G, 4), voting pixels)."""
    B, G = t.x.shape
    thetas = torch.zeros((B * G, 4), dtype=torch.float32, device=t.x.device)
    ovalid = torch.zeros((B * G, 4), dtype=torch.bool, device=t.x.device)
    pixels = 0
    for sel in _valid_chunks(t.valid, CHUNK):
        (kx, ky, ks), gwin, rwin, x0, y0, w, h = _gather(
            (t.x, t.y, t.sigma), t.level, flat, owin, sel)
        votes, npix = _histogram36(kx, ky, ks, gwin, rwin, x0, y0, w, h,
                                   s.orientation_gaussian_factor,
                                   s.orientation_window_factor)
        votes = _smooth6(votes)
        if s.half_sift:
            votes = torch.cat([votes[:, :18] + votes[:, 18:],
                               torch.zeros_like(votes[:, 18:])], dim=1)
        th, ov = _peaks(votes, single, s.multi_orientation_threshold,
                        s.max_orientations)
        thetas[sel], ovalid[sel] = th, ov
        pixels += int(npix.sum())
    return thetas.reshape(B, G, 4), ovalid.reshape(B, G, 4), pixels


def _cell_bin_sums(cu, cv, theta_pix, weight):
    K = cu.shape[0]
    fo = torch.floor(theta_pix)
    ob = fo.to(torch.int64).clamp_(0, 7)
    w2 = theta_pix - fo
    w1 = 1.0 - w2
    cells = torch.arange(4, dtype=torch.float32, device=cu.device)
    ax = (1.0 - (cu.reshape(K, -1, 1) - cells).abs()).clamp_(min=0.0)
    ay = (1.0 - (cv.reshape(K, -1, 1) - cells).abs()).clamp_(min=0.0)
    bins = torch.arange(8, device=cu.device)
    obf = ob.reshape(K, -1, 1)
    o_mat = (w1.reshape(K, -1, 1) * (obf == bins)
             + w2.reshape(K, -1, 1) * (((obf + 1) % 8) == bins))
    o_mat = o_mat * weight.reshape(K, -1, 1)
    spatial = (ay[:, :, :, None] * ax[:, :, None, :]).reshape(K, -1, 16)
    return torch.matmul(spatial.transpose(1, 2), o_mat)


def _descriptor_windows(kx, ky, sigma, theta, gwin, rwin, x0, y0, width,
                        height, window_factor):
    k3 = lambda a: a[:, None, None]
    ar = torch.arange(gwin.shape[-1], dtype=torch.float32, device=x0.device)
    iy = y0[:, None, None] + ar[None, :, None]
    ix = x0[:, None, None] + ar[None, None, :]
    dx = (ix + 0.5) - k3(kx)
    dy = (iy + 0.5) - k3(ky)
    spt = (sigma * window_factor).abs()
    crspt = k3(torch.cos(theta) / spt)
    srspt = k3(torch.sin(theta) / spt)
    u = crspt * dx + srspt * dy
    v = crspt * dy - srspt * dx
    anglef = k3(torch.where(theta > math.pi, theta - 2.0 * math.pi, theta))
    gauss_w = torch.exp(-0.125 * (u * u + v * v))
    cu = u + 1.5
    cv = v + 1.5
    in_support = (cu > -1.0) & (cu < 4.0) & (cv > -1.0) & (cv < 4.0)
    interior = ((ix >= 1.0) & (ix <= (width - 2.0)[:, None, None])
                & (iy >= 1.0) & (iy <= (height - 2.0)[:, None, None]))
    mask = interior & in_support
    theta_pix = (anglef - rwin) * (4.0 / math.pi)
    theta_pix = torch.where(theta_pix < 0, theta_pix + 8.0, theta_pix)
    weight = torch.where(mask, gauss_w * gwin, 0.0)
    return (_cell_bin_sums(cu, cv, theta_pix, weight),
            mask.sum(dim=(1, 2), dtype=torch.int64))


def descriptors(t: Table, flat, s: Settings, dwin: int):
    """Normalized (B, N, 128) descriptors and the pixels they read."""
    B, G = t.x.shape
    raw = torch.zeros((B * G, 16, 8), dtype=torch.float32, device=t.x.device)
    pixels = 0
    chunk = max(1, min(CHUNK, (1 << 27) // (dwin * dwin * 16)))
    for sel in _valid_chunks(t.valid, chunk):
        (kx, ky, ks, kt), gwin, rwin, x0, y0, w, h = _gather(
            (t.x, t.y, t.sigma, t.theta), t.level, flat, dwin, sel)
        raw[sel], npix = _descriptor_windows(
            kx, ky, ks, kt, gwin, rwin, x0, y0, w, h,
            s.descriptor_window_factor)
        pixels += int(npix.sum())
    d = torch.where(t.valid.reshape(-1)[:, None, None], raw, 0.0)
    if s.half_sift:
        d = d[..., :4] + d[..., 4:]
    d = d.flatten(-2).reshape(B, G, -1)
    if s.normalized_sift:
        eps = 1e-12
        n1 = torch.rsqrt((d * d).sum(dim=-1, keepdim=True) + eps)
        d = (d * n1).clamp(max=0.2)
        n2 = torch.rsqrt((d * d).sum(dim=-1, keepdim=True) + eps)
        d = torch.where(t.valid[..., None], d * n2, 0.0)
    return d, pixels


def window_sizes(s: Settings):
    max_sigma = s.key_level_sigma(s.key_levels[-1]) * \
        (s.sigmak if s.subpixel else 1.0)
    owin = 2 * int(math.ceil(abs(max_sigma) * s.orientation_gaussian_factor
                             * s.orientation_window_factor + 1.0)) + 1
    spt = abs(max_sigma * s.descriptor_window_factor)
    dwin = 2 * (int(math.ceil(2.5 * math.sqrt(2.0) * spt + 1.0)) + 1) + 1
    return owin, dwin


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class Work(NamedTuple):
    """What these inputs need of the per-keypoint and detect stages."""
    valid_cells: tuple       # valid detect cells per octave, whole batch
    oriented_keypoints: int  # valid rows the orientation stage reads
    table_rows: int          # rows of the global table (B * G)
    ori_pixels: int          # pixels that voted, over every keypoint
    described_rows: int      # valid rows the descriptor stage reads
    desc_table_rows: int     # rows of the described table (B * N)
    desc_pixels: int         # pixels that contributed to a descriptor


@contextlib.contextmanager
def _tf32(allow: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@torch.no_grad()
def run(frames: torch.Tensor, s: Settings, plane_dtype=torch.float32,
        tf32: bool = False):
    """(Table in image coordinates with desc, Work) of a (B, H, W) float32
    batch, on the frames' device. tf32=True runs the descriptor's matrix
    product in TF32 (a witness for the comparison, never the reference)."""
    if frames.ndim != 3 or frames.dtype != torch.float32:
        raise ValueError("reference: expected (B, H, W) float32 frames")
    with _tf32(tf32):
        return _run(frames.contiguous(), s, plane_dtype)


def _run(frames, s: Settings, plane_dtype):
    plan = make_plan(frames.shape[1], frames.shape[2], s)
    dev = frames.device
    octaves = build_pyramid(frames, plan, s, plane_dtype)
    nk = len(s.key_levels)
    sigmas = torch.tensor([s.key_level_sigma(k) for k in s.key_levels],
                          dtype=torch.float32, device=dev)
    lists, grads, rots, valid_cells = [], [], [], []
    for o, g in enumerate(octaves):
        maps, grad, rot = detect_octave(g, s)
        grads.append(grad)
        rots.append(rot)
        valid_cells.append(int(maps.valid.sum()))
        lists.append(compact_octave(maps, sigmas, s.sigmak,
                                    plan.level_caps[o]))
    del octaves
    lid = np.concatenate([np.repeat(o * nk + np.arange(nk), plan.level_caps[o])
                          for o in range(len(plan.octave_shapes))])
    level_ids = torch.as_tensor(lid, dtype=torch.int32, device=dev)
    cat = lambda i: torch.cat([fl[i].flatten(-2) for fl in lists], dim=-1)
    valid = cat(5)
    G = min(s.global_feature_cap, nk * sum(plan.level_caps))
    (x, y, sg, r, ft, lv), sv = compact_sorted(
        valid, [cat(0), cat(1), cat(2), cat(3), cat(4),
                level_ids.expand(valid.shape)], G)
    t = Table(x, y, sg, torch.zeros_like(x), r, ft, lv, sv)
    flat = _flat_levels(grads, rots)
    owin, dwin = window_sizes(s)
    single = s.max_orientations <= 1 or s.fixed_orientation
    n_kp, ori_px = int(t.valid.sum()), 0
    if not s.fixed_orientation:
        thetas, ovalid, ori_px = orientations(t, flat, s, owin, single)
        if single:
            t = t._replace(theta=thetas[..., 0].contiguous())
        else:
            g_exp = int(G * s.expansion_factor + 7) // 8 * 8
            t = _expand(t, thetas, ovalid, g_exp)
    desc_px = 0
    if s.compute_descriptors:
        desc, desc_px = descriptors(t, flat, s, dwin)
    else:
        desc = torch.zeros(t.x.shape + (64 if s.half_sift else 128,),
                           dtype=torch.float32, device=dev)
    offset = 0.0 if s.lowe_origin else 0.5
    octave_id = torch.div(t.level, s.num_scales, rounding_mode="floor")
    oss = torch.exp2(octave_id.to(torch.float32))
    out = Table(
        x=oss * (t.x - 0.5) + offset, y=oss * (t.y - 0.5) + offset,
        sigma=oss * t.sigma,
        theta=torch.where(t.valid, torch.remainder(TWO_PI - t.theta, TWO_PI),
                          torch.zeros_like(t.theta)),
        response=t.response, ftype=t.ftype, level=t.level, valid=t.valid,
        desc=desc)
    work = Work(tuple(valid_cells), n_kp if not s.fixed_orientation else 0,
                int(x.numel()), int(ori_px),
                int(t.valid.sum()) if s.compute_descriptors else 0,
                int(t.x.numel()) if s.compute_descriptors else 0,
                int(desc_px))
    return out, work
