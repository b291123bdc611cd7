"""The detect kernel's output contract, held on the CPU through its plain
version.

On a CUDA tensor ops/cuda/detect.detect_octave writes valid, grad and rot at
every cell but the keypoint payload - response, dx, dy, ds, ftype - only
where valid is set; the rest of those maps is whatever torch.empty gave.
The kernel cannot run here, so these tests take the plain version's dense
maps, poison every payload cell that is not valid (NaN, +-Inf, huge and
random values, cell 0 included: compaction gathers it for every empty
slot) and check that nothing downstream can tell:

  * compact_octave_keypoints gives the identical FeatureList;
  * detect_from_octaves, with the poisoned maps in place of the detector's,
    gives the identical GlobalTable, level counts and gradient maps.

The kernel also runs its cheap test first: the NMS and everything after it
run only for warps (32 adjacent columns of one row) with a lane that is
inside the one-pixel border and passes the threshold (darkness adaption
included). `test_threshold_gate_keeps_every_keypoint` holds that gate
against the plain maps: every keypoint passes it, so gating cannot drop one.

Tolerance: none, every comparison is bit for bit. No JAX: the contract is
the port's own; tests/test_torch_detect.py holds the plain version against
the JAX package.
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import SiftConfig, make_plan
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.ops import hessian
from hessgpu_tpu_torch.ops.compaction import compact_octave_keypoints
from hessgpu_tpu_torch.ops.cuda.detect import detect_octave_plain
from hessgpu_tpu_torch.ops.keypoint import f32
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

SHAPE = (2, 96, 128)
PAYLOAD = ("response", "dx", "dy", "ds", "ftype")
CASES = [("hessian", True), ("hessian", False), ("dog", True), ("dog", False)]
IDS = ["hessian-sub", "hessian-nosub", "dog-sub", "dog-nosub"]


def _config(detector, subpixel, **kw):
    # a lower threshold than the default, so that the small frames hold
    # keypoints on every key level
    return SiftConfig(detector=detector, subpixel=subpixel, threshold=0.002,
                      compute_descriptors=False, fixed_orientation=True, **kw)


def _octaves(cfg):
    b, h, w = SHAPE
    imgs = torch.from_numpy(np.stack([texture_frame(s, h, w)
                                      for s in range(b)]))
    plan = make_plan(h, w, cfg)
    return tpyr._build_pyramid(imgs, plan, cfg), plan


def _poison(maps, seed):
    """The maps with every payload cell that is not valid overwritten by
    NaN, +Inf, -Inf, +-3e38 or random values, in a seeded pattern; cell 0 of
    every plane holds NaN (int maps: random ints)."""
    rng = np.random.RandomState(seed)
    off = ~maps.valid
    assert bool(off.reshape(off.shape[:2] + (-1,))[..., 0].all())
    junk = {}
    for f in PAYLOAD:
        a = getattr(maps, f)
        if a.is_floating_point():
            pool = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38],
                            np.float32)
            bad = np.where(rng.rand(*a.shape) < 0.5,
                           pool[rng.randint(0, len(pool), a.shape)],
                           rng.randn(*a.shape).astype(np.float32) * 1e4)
            bad.reshape(a.shape[:2] + (-1,))[..., 0] = np.nan
        else:
            bad = rng.randint(-2 ** 31, 2 ** 31 - 1, a.shape)
        bad = torch.from_numpy(bad.astype(a.numpy().dtype))
        junk[f] = torch.where(off, bad, a)
    return maps._replace(**junk)


def _assert_identical(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f


@pytest.mark.parametrize("detector,subpixel", CASES, ids=IDS)
def test_compaction_reads_payload_at_valid_cells_only(detector, subpixel):
    cfg = _config(detector, subpixel)
    octaves, plan = _octaves(cfg)
    p = cfg.scale_params()
    sigmas = [p.key_level_sigma(k) for k in p.key_levels]
    nk = len(p.key_levels)
    kept = 0
    for o, stack in enumerate(octaves[:3]):
        maps, _, _ = tpyr._detect_octave(stack, cfg)
        cap = plan.level_caps[o * nk]
        want = compact_octave_keypoints(maps, sigmas, p.sigmak, cap)
        got = compact_octave_keypoints(_poison(maps, o), sigmas, p.sigmak,
                                       cap)
        _assert_identical(got, want)
        for f in ("x", "y", "sigma", "response"):
            assert bool(torch.isfinite(getattr(got, f)).all()), f
        kept += int(want.valid.sum())
    assert kept >= 20, f"only {kept} keypoints exercised"


@pytest.mark.parametrize("detector,subpixel", CASES, ids=IDS)
def test_global_table_reads_payload_at_valid_cells_only(
        detector, subpixel, monkeypatch):
    cfg = _config(detector, subpixel)
    octaves, plan = _octaves(cfg)
    want_table, want_maps, want_aux = tpyr.detect_from_octaves(
        octaves, plan, cfg)
    assert int(want_table.valid.sum()) >= 20

    detect = tpyr._detect_octave
    seeds = iter(range(100))

    def poisoned(gauss_oct, cfg, plain=False):
        maps, grad, rot = detect(gauss_oct, cfg, plain)
        return _poison(maps, next(seeds)), grad, rot

    monkeypatch.setattr(tpyr, "_detect_octave", poisoned)
    table, maps, aux = tpyr.detect_from_octaves(octaves, plan, cfg)
    assert next(seeds) == len(octaves)      # every octave went through it
    _assert_identical(table, want_table)
    for a, b in zip(maps.grad + maps.rot, want_maps.grad + want_maps.rot):
        assert torch.equal(a, b)
    for k in ("level_counts", "pre_count"):
        assert torch.equal(aux[k], want_aux[k]), k


@pytest.mark.parametrize("darkness", [False, True], ids=["noda", "da"])
@pytest.mark.parametrize("detector,subpixel", CASES, ids=IDS)
def test_threshold_gate_keeps_every_keypoint(detector, subpixel, darkness):
    """The kernel's first gate, per cell: inside the one-pixel border and
    |response| > thr0 (0.8 T with subpixel, T without; T scaled by
    min(2 g + 0.1, 1) under darkness adaption). Every valid cell of the
    plain maps passes it, and so does every warp that holds one."""
    cfg = _config(detector, subpixel, darkness_adaption=darkness)
    octaves, _ = _octaves(cfg)
    p = cfg.scale_params()
    kl = list(p.key_levels)
    keys = 0
    for stack in octaves[:3]:
        maps, _, _ = detect_octave_plain(
            stack, tpyr._detect_norms(p, cfg), kl, threshold=p.threshold,
            edge_threshold=p.edge_threshold, subpixel=subpixel,
            darkness_adaption=darkness, detector=detector)
        if detector == "hessian":
            resp = hessian.hessian_response_and_gradient(
                stack, tpyr._detect_norms(p, cfg), grad_levels=kl)[0][:, kl]
        else:
            resp = hessian.dog_response_and_gradient(stack)[0][:, kl]
        thr = torch.full_like(resp, f32(p.threshold))
        if darkness:
            thr = f32(p.threshold) * torch.clamp(
                2.0 * stack[:, kl] + f32(0.1), max=1.0)
        thr0 = f32(0.8) * thr if subpixel else thr
        h, w = resp.shape[-2:]
        rows = torch.arange(h).reshape(-1, 1)
        cols = torch.arange(w).reshape(1, -1)
        interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
        gate = interior & (resp.abs() > thr0)
        assert not bool((maps.valid & ~gate).any())
        # per warp: 32 adjacent columns of one row, from column 0
        pad = (-w) % 32
        seg = lambda m: torch.nn.functional.pad(m, (0, pad)).reshape(
            m.shape[:-1] + (-1, 32)).any(-1)
        assert not bool((seg(maps.valid) & ~seg(gate)).any())
        keys += int(maps.valid.sum())
    assert keys >= 20, f"only {keys} keypoints exercised"
