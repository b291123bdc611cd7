"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need one NVIDIA GPU and
nvcc; everywhere else they skip. They import nothing of JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

(--noconftest because tests/conftest.py sets up JAX, which this file does
not use.) Whether there is a card is decided inside the `card` fixture, never
at import, so every pytest worker collects the same tests.

Tolerances: blur, chain, decimation and valid are bit-equal (same tap
order, -fmad=false), and so are ftype, response, dx, dy, ds at the valid
cells, the only cells where the detect kernel writes them; grad 1e-6
relative (sqrtf is IEEE on both sides, one last bit allowed), rot 2e-6 rad
(atan2f vs torch.atan2 may differ in the last bit). The per-keypoint
kernels sum a keypoint's pixels in another order than torch.sum /
torch.matmul: smoothed votes and raw descriptor entries within
VOTE_TOL = 2e-5 of the keypoint's largest entry
(1e-6 * sqrt(N) for N of a few hundred terms), normalized descriptors within
2e-6. Orientations are discrete; the plain peak picker applied to the
kernel's own histograms must reproduce the kernel's thetas exactly, so a
keypoint whose orientations differ between the two routes differs through
its histogram alone, and that is within tolerance. The small-SVD kernels
(csrc/linalg.cu) equal their plain versions (ops/linalg.py) bit for bit,
the sweeps each matrix ran too: the same Gram sums, rotations, convergence
test and sign rule in float64, -fmad=false.
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import SiftConfig, detect_batch, make_plan
from hessgpu_tpu_torch import pyramid as tpyr
from hessgpu_tpu_torch.ops import gaussian
from hessgpu_tpu_torch.ops import linalg
from hessgpu_tpu_torch.ops.cuda import (conv, detect, launch_counts, patch,
                                        reset_launch_counts)
from hessgpu_tpu_torch.ops.cuda import linalg as cuda_linalg
from hessgpu_tpu_torch.ops.descriptor import finalize_descriptors
from hessgpu_tpu_torch.ops.orientation import peaks_from_votes
from hessgpu_tpu_torch.params import gaussian_taps
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from hessgpu_tpu_torch.utils.graphs import disable_graphs
from test_torch_blur_tiling import _segment_rows

pytestmark = pytest.mark.gpu

SLICE = dict(compute_descriptors=False, fixed_orientation=True)
SHAPES = [(2, 96, 128), (1, 101, 75), (3, 30, 40)]
VOTE_TOL = 2e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernels have no "
                    "interpret mode")
    return torch.device("cuda", 0)


def _planes(shape, seed, device):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _texture_batch(shape, device):
    b, h, w = shape
    frames = np.stack([texture_frame(seed, h, w) for seed in range(b)])
    return torch.from_numpy(frames).to(device)


# the main path's initial blur and the octave shapes below it, a batch of
# 17, one row, one column, widths smaller than the 33-tap halo
BLUR_SHAPES = SHAPES + [(16, 480, 640), (16, 240, 320), (16, 120, 160),
                        (16, 60, 80), (16, 30, 40), (17, 101, 75),
                        (2, 1, 77), (2, 50, 1), (3, 40, 7), (2, 5, 9)]


@pytest.mark.parametrize("shape", BLUR_SHAPES, ids=str)
@pytest.mark.parametrize("sigma", [0.8, 1.5199, 5.0])   # 5, 13 and 33 taps
def test_blur_kernel_equals_plain(card, shape, sigma):
    x = _planes(shape, 1, card)
    taps = gaussian_taps(sigma)
    assert torch.equal(conv.blur(x, taps), conv.blur_plain(x, taps))


@pytest.mark.parametrize("shape", BLUR_SHAPES, ids=str)
def test_blur_segments_follow_the_modelled_rule(card, shape):
    """The kernel's segment height is the one tests/test_torch_blur_tiling.py
    models (and holds bit-equal to the plain blur)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    x = _planes(shape, 1, card)
    assert conv.blur_segment_rows(x) == _segment_rows(*shape, sms=sms)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_octave_chain_kernel_equals_plain(card, shape, detector):
    x = _planes(shape, 2, card)
    taps_list = gaussian.chain_taps(SiftConfig(detector=detector).scale_params())
    got = conv.octave_chain(x, taps_list)
    assert got.shape == (shape[0], 1 + len(taps_list)) + shape[1:]
    assert torch.equal(got, conv.octave_chain_plain(x, taps_list))


@pytest.mark.parametrize("shape", [(3, 30, 40), (1, 101, 75), (2, 200, 264)],
                         ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("variant", ["33-taps", "identity", "default-taps"])
def test_octave_chain_kernel_beyond_the_default(card, shape, detector,
                                                variant):
    """An image smaller than the chain's halo, an odd one and one that no
    tile of the kernel's list divides (200 x 264: ragged tiles on both axes),
    with four 33-tap transitions (cumulative halo 64: groups of levels where
    the image is larger than a tile plus the halo), with an identity
    transition, and with the detector's own taps."""
    x = _planes(shape, 8, card)
    taps_list = gaussian.chain_taps(SiftConfig(detector=detector).scale_params())
    if variant == "33-taps":
        taps_list = [gaussian_taps(5.0)] * 4
    elif variant == "identity":
        taps_list = [taps_list[0], (), *taps_list[1:]]
    got = conv.octave_chain(x, taps_list)
    groups = conv.octave_chain_groups(x, taps_list)
    assert torch.equal(got, conv.octave_chain_plain(x, taps_list))
    if variant == "33-taps" and shape[1] >= 200:
        assert groups >= 2
    else:
        assert groups == 1


@pytest.mark.parametrize("shape", SHAPES + [(2, 31, 33)], ids=str)
def test_downsample2_kernel_equals_plain(card, shape):
    x = _planes(shape, 3, card)
    assert torch.equal(conv.downsample2(x), x[:, ::2, ::2])
    stack = _planes((shape[0], 5) + shape[1:], 4, card)
    view = stack[:, 3]                       # read in place, not contiguous
    assert torch.equal(conv.downsample2(view), stack[:, 3, ::2, ::2])


# the main path's octave shapes, an odd one and one smaller than the halo
FUSED_SHAPES = [(16, 480, 640), (16, 240, 320), (16, 120, 160), (16, 60, 80),
                (2, 101, 75), (3, 30, 40)]


def _fused(x, taps_list, level):
    """octave_chain_into in place from x, decimating `level` into level 0
    of a stack of the next octave's shape; returns (stack, next stack)."""
    B, H, W = x.shape
    stack = torch.empty((B, 1 + len(taps_list), H, W), device=x.device)
    stack[:, 0] = x
    nxt = torch.full((B, 3, H // 2, W // 2), float("nan"), device=x.device)
    conv.octave_chain_into(stack, taps_list, decimate_level=level,
                           next_base=nxt[:, 0])
    return stack, nxt


def _decimated(level_plane):
    _, H, W = level_plane.shape
    return conv.downsample2_plain(level_plane)[..., :H // 2, :W // 2]


@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_fused_decimation_equals_plain(card, shape, detector):
    """The main path's chain: in place, level level_ds decimated by the
    chain's epilogue into the next stack's level 0, which is the plain
    decimation cropped to the floor-halved shape; nothing else written."""
    p = SiftConfig(detector=detector).scale_params()
    taps_list = gaussian.chain_taps(p)
    lds = p.level_ds - p.level_min
    x = _planes(shape, 9, card)
    stack, nxt = _fused(x, taps_list, lds)
    want = conv.octave_chain_plain(x, taps_list)
    assert torch.equal(stack, want)
    assert torch.equal(nxt[:, 0], _decimated(want[:, lds]))
    assert bool(nxt[:, 1:].isnan().all())


@pytest.mark.parametrize("shape", [(2, 200, 264), (1, 101, 75), (3, 30, 40)],
                         ids=str)
@pytest.mark.parametrize("level", range(5), ids=lambda l: f"level{l}")
@pytest.mark.parametrize("variant", ["33-taps", "identity"])
def test_fused_decimation_at_every_level(card, shape, level, variant):
    """Four 33-tap transitions (groups of levels at 200 x 264: the level a
    group's base, inside a later group, a launch's last), and a chain with
    an identity transition (level 2 is the identity's copy)."""
    taps_list = [gaussian_taps(5.0)] * 4
    if variant == "identity":
        taps_h = gaussian.chain_taps(SiftConfig().scale_params())
        taps_list = [taps_h[0], (), taps_h[1], taps_h[2]]
    x = _planes(shape, 10, card)
    stack, nxt = _fused(x, taps_list, level)
    want = conv.octave_chain_plain(x, taps_list)
    assert torch.equal(stack, want)
    assert torch.equal(nxt[:, 0], _decimated(want[:, level]))


@pytest.mark.parametrize("shape", [(16, 480, 640), (2, 101, 75)], ids=str)
def test_blur_into_a_plane_of_a_stack(card, shape):
    x = _planes(shape, 11, card)
    taps = gaussian_taps(1.5199)
    stack = torch.full((shape[0], 5) + shape[1:], float("nan"), device=card)
    conv.blur(x, taps, out=stack[:, 0])
    assert torch.equal(stack[:, 0], conv.blur_plain(x, taps))
    assert bool(stack[:, 1:].isnan().all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("subpixel", [True, False], ids=["sub", "nosub"])
@pytest.mark.parametrize("darkness", [False, True], ids=["noda", "da"])
def test_detect_kernel_equals_plain(card, shape, detector, subpixel, darkness):
    cfg = SiftConfig(detector=detector, subpixel=subpixel,
                     darkness_adaption=darkness, **SLICE)
    p = cfg.scale_params()
    stack = conv.octave_chain_plain(_texture_batch(shape, card),
                                    gaussian.chain_taps(p))
    args = (stack, tpyr._detect_norms(p, cfg), p.key_levels)
    kw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
              subpixel=subpixel, darkness_adaption=darkness,
              detector=detector)
    gm, ggrad, grot = detect.detect_octave(*args, **kw)
    wm, wgrad, wrot = detect.detect_octave_plain(*args, **kw)
    # the kernel writes the payload only where valid is set (its contract)
    assert torch.equal(gm.valid, wm.valid)
    for f in ("response", "dx", "dy", "ds", "ftype"):
        assert torch.equal(getattr(gm, f)[wm.valid],
                           getattr(wm, f)[wm.valid]), f
    torch.testing.assert_close(ggrad, wgrad, rtol=1e-6, atol=0)
    torch.testing.assert_close(grot, wrot, rtol=0, atol=2e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = _planes((2, 40, 48), 5, card)
    with pytest.raises(ValueError, match="contiguous"):
        conv.blur(x.transpose(1, 2), gaussian_taps(1.0))
    with pytest.raises(ValueError, match="contiguous"):
        conv.octave_chain(x[:, ::2], [gaussian_taps(1.0)])
    with pytest.raises(ValueError, match="contiguous"):
        conv.downsample2(x.transpose(1, 2))
    stack = _planes((2, 5, 40, 48), 7, card)
    with pytest.raises(ValueError, match="contiguous"):
        conv.octave_chain_into(stack[..., ::2], [gaussian_taps(1.0)] * 4)
    with pytest.raises(ValueError, match="rows"):
        conv.blur(x, gaussian_taps(1.0), out=stack[:, 0, :, :].transpose(1, 2)
                  .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        detect.detect_octave(
            _planes((1, 5, 40, 96), 6, card)[..., ::2], [1.0] * 5, [1, 2, 3],
            threshold=0.01, edge_threshold=10.0)


def _keypoint_scene(card, shape, detector, **kw):
    """Table, maps and window sizes of a seeded batch, as the pipeline hands
    them to the per-keypoint stages."""
    cfg = SiftConfig(detector=detector, **kw)
    plan = make_plan(shape[1], shape[2], cfg)
    octaves = tpyr._build_pyramid(_texture_batch(shape, card), plan, cfg)
    table, maps, _ = tpyr.detect_from_octaves(octaves, plan, cfg)
    p = cfg.scale_params()
    owin, dwin = tpyr.window_sizes(
        cfg, p.key_level_sigma(p.key_levels[-1]) * p.sigmak)
    assert int(table.valid.sum()) >= 3
    return cfg, table, maps, owin, dwin


ORI_MODES = [dict(single=True), dict(max_peaks=1), dict(max_peaks=2),
             dict(max_peaks=3), dict(max_peaks=4),
             dict(max_peaks=2, half_sift=True),
             dict(single=True, half_sift=True)]


def _check_orientation(t, maps, owin, mode):
    """The orientation kernel against its plain version on one table: the
    same bits twice, zeros where not valid, votes within VOTE_TOL, thetas
    and valid equal to the plain peak picking on the kernel's own votes,
    single-mode thetas within 1e-4 rad of the plain version's."""
    args = (t.x, t.y, t.sigma, t.valid, t.level_id, maps, owin)
    got = patch.orientation(*args, return_votes=True, **mode)
    again = patch.orientation(*args, return_votes=True, **mode)
    want = patch.orientation_plain(*args, **mode)
    for a, b in zip(got, again):                    # deterministic
        assert a is None or torch.equal(a, b)
    scale = want.votes.amax(-1, keepdim=True).clamp_min(1e-30)
    assert float(((got.votes - want.votes).abs() / scale).max()) <= VOTE_TOL
    single = mode.get("single", False) or mode.get("max_peaks", 4) <= 1
    th, ov = peaks_from_votes(got.votes, single=single,
                              max_peaks=mode.get("max_peaks", 4))
    inv = ~t.valid[..., None]
    assert torch.equal(ov & ~inv, got.valid)
    assert torch.equal(th.masked_fill(inv, 0.0), got.thetas)
    assert not bool(got.valid[~t.valid].any())      # zeros on invalid slots
    assert not bool(got.thetas[~t.valid].any())
    assert not bool(got.votes[~t.valid].any())
    differing = ((got.valid != want.valid).any(-1)
                 | (got.thetas != want.thetas).any(-1))
    if single:
        torch.testing.assert_close(got.thetas, want.thetas, rtol=0, atol=1e-4)
    else:
        assert int(differing.sum()) <= max(1, int(t.valid.sum()) // 100)
    return want


@pytest.mark.parametrize("shape", [(2, 160, 200), (1, 101, 75), (3, 30, 40)],
                         ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("mode", ORI_MODES, ids=lambda m: "-".join(
    f"{k}{int(v)}" for k, v in m.items()))
def test_orientation_kernel_against_plain(card, shape, detector, mode):
    _, t, maps, owin, _ = _keypoint_scene(card, shape, detector,
                                          threshold=0.002)
    _check_orientation(t, maps, owin, mode)


@pytest.mark.parametrize("detector", ["hessian", "dog"])
@pytest.mark.parametrize("mode", ORI_MODES, ids=lambda m: "-".join(
    f"{k}{int(v)}" for k, v in m.items()))
def test_orientation_kernel_large_support(card, detector, mode):
    """Every sigma scaled by 6: boxes of thousands to 10^4 pixels, the
    supports describe_keypoints meets with a user's large keypoints."""
    cfg, t, maps, _, _ = _keypoint_scene(card, (2, 160, 200), detector,
                                         threshold=0.002)
    big = t._replace(sigma=(t.sigma * 6.0).contiguous())
    owin = tpyr.window_sizes(cfg, float(big.sigma[big.valid].max()))[0]
    want = _check_orientation(big, maps, owin, mode)
    assert int(want.support[big.valid].max()) > 2000


@pytest.mark.parametrize("table", ["all-invalid", "single-slot"])
def test_orientation_kernel_sparse_tables(card, table):
    """A table with no valid slot gives zeros everywhere; a single valid slot
    (not at the front of its row) gives its result there and zeros
    elsewhere."""
    _, t, maps, owin, _ = _keypoint_scene(card, (2, 160, 200), "hessian",
                                          threshold=0.002)
    full = patch.orientation(t.x, t.y, t.sigma, t.valid, t.level_id, maps,
                             owin, return_votes=True)
    valid = torch.zeros_like(t.valid)
    if table == "single-slot":
        assert bool(t.valid[1, 2])
        valid[1, 2] = True
    sparse = t._replace(valid=valid)
    _check_orientation(sparse, maps, owin, dict(max_peaks=2))
    got = patch.orientation(t.x, t.y, t.sigma, valid, t.level_id, maps, owin,
                            return_votes=True)
    if table == "single-slot":
        for a, b in zip(got, full):
            assert a is None or torch.equal(a[1, 2], b[1, 2])
    else:
        assert not any(bool(a.any()) for a in got if a is not None)


@pytest.mark.parametrize("shape", [(2, 160, 200), (1, 101, 75), (3, 30, 40)],
                         ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_descriptor_kernel_against_plain(card, shape, detector):
    cfg, t, maps, owin, dwin = _keypoint_scene(card, shape, detector,
                                               threshold=0.002)
    theta = tpyr.orient_table(t, maps, cfg, owin, True).thetas[..., 0] \
        .contiguous()
    args = (t.x, t.y, t.sigma, theta, t.valid, t.level_id, maps, dwin)
    got = patch.descriptor(*args)
    assert torch.equal(got, patch.descriptor(*args))            # deterministic
    want = patch.descriptor_plain(*args)
    assert got.shape == want.shape == t.x.shape + (16, 8)
    assert not bool(got[~t.valid].any())
    scale = want.abs().amax((-2, -1), keepdim=True).clamp_min(1e-30)
    assert float(((got - want).abs() / scale).max()) <= VOTE_TOL
    for half in (False, True):
        a = finalize_descriptors(got, t.valid, half, True)
        b = finalize_descriptors(want, t.valid, half, True)
        assert float((a - b).abs().max()) <= 2e-6
        norms = a[t.valid].norm(dim=-1)
        assert float((norms - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("table", ["all-invalid", "single-slot"])
def test_descriptor_kernel_sparse_tables(card, table):
    """A table with no valid slot gives zeros everywhere; a single valid slot
    (not at the front of its row) gives its descriptor there and zeros
    elsewhere, the same bits twice."""
    cfg, t, maps, owin, dwin = _keypoint_scene(card, (2, 160, 200), "hessian",
                                               threshold=0.002)
    theta = tpyr.orient_table(t, maps, cfg, owin, True).thetas[..., 0] \
        .contiguous()
    full = patch.descriptor(t.x, t.y, t.sigma, theta, t.valid, t.level_id,
                            maps, dwin)
    valid = torch.zeros_like(t.valid)
    if table == "single-slot":
        assert bool(t.valid[1, 2])
        valid[1, 2] = True
    args = (t.x, t.y, t.sigma, theta, valid, t.level_id, maps, dwin)
    got = patch.descriptor(*args)
    assert torch.equal(got, patch.descriptor(*args))
    assert not bool(got[~valid].any())
    if table == "single-slot":
        assert torch.equal(got[1, 2], full[1, 2]) and bool(got[1, 2].any())
        want = patch.descriptor_plain(*args)
        assert float((got - want).abs().max()) <= VOTE_TOL * float(want.max())


def test_patch_wrappers_refuse_what_the_kernels_do_not_take(card):
    _, t, maps, owin, dwin = _keypoint_scene(card, (2, 96, 128), "hessian")
    with pytest.raises(TypeError):
        patch.orientation(t.x.double(), t.y, t.sigma, t.valid, t.level_id,
                          maps, owin)
    with pytest.raises(ValueError, match="contiguous"):
        patch.descriptor(t.x.t().contiguous().t(), t.y, t.sigma, t.theta,
                         t.valid, t.level_id, maps, dwin)
    with pytest.raises(ValueError):
        patch.orientation(t.x[:1], t.y[:1], t.sigma[:1], t.valid[:1],
                          t.level_id[:1], maps, owin)


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_default_main_path_goes_through_the_kernels(card, detector):
    """detect_batch with the default configuration launches five kernels, and
    the sixth, downsample2, as the chain's decimation epilogue (no launch of
    its own); its table equals the plain versions' on the card up to the
    summation order of the two per-keypoint stages."""
    imgs = _texture_batch((2, 160, 200), card)
    cfg = SiftConfig(detector=detector)
    n_oct = make_plan(160, 200, cfg).num_octaves
    reset_launch_counts()
    with disable_graphs():      # the eager route: its wrappers count launches
        got = detect_batch(imgs, cfg)
    assert launch_counts() == {"blur": 1, "octave_chain": n_oct,
                               "downsample2": 0,
                               "detect_octave": n_oct, "orientation": 1,
                               "descriptor": 1, "null_vector": 0, "svd3": 0,
                               "row_counts": n_oct, "level_scan": 1,
                               "table_scatter": 1}
    want = detect_batch(imgs, cfg, plain=True)
    assert launch_counts()["descriptor"] == 1           # plain launched none
    assert int(got.count().min()) >= 10
    for f in ("valid", "level", "ftype", "x", "y", "sigma", "response",
              "theta"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert float((got.desc - want.desc).abs().max()) <= 2e-6
    assert got.desc.shape == got.x.shape + (128,)


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_main_path_goes_through_the_kernels(card, detector):
    """detect_batch on the card launches every kernel of the path (the
    decimation is the chain's epilogue), and its table equals the plain
    versions' on the card field for field."""
    imgs = _texture_batch((2, 160, 200), card)
    cfg = SiftConfig(detector=detector, **SLICE)
    n_oct = make_plan(160, 200, cfg).num_octaves
    reset_launch_counts()
    with disable_graphs():      # the eager route: its wrappers count launches
        got = detect_batch(imgs, cfg)
    assert launch_counts() == {"blur": 1, "octave_chain": n_oct,
                               "downsample2": 0,
                               "detect_octave": n_oct, "orientation": 0,
                               "descriptor": 0, "null_vector": 0, "svd3": 0,
                               "row_counts": n_oct, "level_scan": 1,
                               "table_scatter": 1}
    want = detect_batch(imgs, cfg, plain=True)
    assert launch_counts()["detect_octave"] == n_oct     # plain launched none
    assert int(got.count().min()) >= 10
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---- conv_mode="direct" and the upsampled first octave ----------------------

@pytest.mark.parametrize("shape", [(16, 480, 640), (2, 101, 75), (3, 30, 40)],
                         ids=str)
@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_direct_pyramid_kernel_route_equals_plain(card, shape, detector):
    """The direct pyramid on the card (one blur launch per level past level
    0, the standalone decimation between octaves, cropped) against its plain
    route on the card, every level of every octave bit for bit."""
    cfg = SiftConfig(detector=detector, conv_mode="direct", **SLICE)
    p = cfg.scale_params()
    plan = make_plan(*shape[1:], cfg)
    imgs = _texture_batch(shape, card)
    reset_launch_counts()
    got = tpyr._build_pyramid(imgs, plan, cfg)
    blurred = sum(1 for t in gaussian.direct_taps(p) if len(t))
    assert launch_counts() == {
        "blur": 1 + blurred * plan.num_octaves, "octave_chain": 0,
        "downsample2": plan.num_octaves - 1, "detect_octave": 0,
        "orientation": 0, "descriptor": 0, "null_vector": 0, "svd3": 0,
        "row_counts": 0, "level_scan": 0, "table_scatter": 0}
    want = tpyr._build_pyramid(imgs, plan, cfg, plain=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_u8_input_converts_as_on_the_cpu(card):
    """A u8 image (a PGM through HessianSift) becomes the same floats on the
    card as on the CPU: CUDA's division by a scalar would multiply by the
    reciprocal."""
    from hessgpu_tpu_torch.ops.resize import to_float
    x = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    assert torch.equal(to_float(x.to(card)).cpu(), to_float(x))
    img = (np.clip(texture_frame(0, 48, 64), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert torch.equal(tpyr.prepare_input(img, SiftConfig(), card)[0].cpu(),
                       tpyr.prepare_input(img, SiftConfig(), "cpu")[0])


@pytest.mark.parametrize("detector", ["hessian", "dog"])
def test_direct_main_path_goes_through_the_kernels(card, detector):
    imgs = _texture_batch((2, 160, 200), card)
    cfg = SiftConfig(detector=detector, conv_mode="direct", **SLICE)
    n_oct = make_plan(160, 200, cfg).num_octaves
    levels = 4 if detector == "hessian" else 5
    reset_launch_counts()
    with disable_graphs():      # the eager route: its wrappers count launches
        got = detect_batch(imgs, cfg)
    assert launch_counts() == {"blur": 1 + levels * n_oct, "octave_chain": 0,
                               "downsample2": n_oct - 1,
                               "detect_octave": n_oct, "orientation": 0,
                               "descriptor": 0, "null_vector": 0, "svd3": 0,
                               "row_counts": n_oct, "level_scan": 1,
                               "table_scatter": 1}
    want = detect_batch(imgs, cfg, plain=True)
    assert int(got.count().min()) >= 10
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_upsampled_octave_through_the_chain_and_detect(card):
    """DoG at first_octave -1 on a 640x480 batch: octave 0 is 960x1280. The
    in-place chain and the detect kernel at that size against their plain
    versions on the card."""
    from hessgpu_tpu_torch.ops.resize import upsample
    cfg = SiftConfig(detector="dog", first_octave=-1, **SLICE)
    p = cfg.scale_params()
    imgs = upsample(_texture_batch((16, 480, 640), card))
    assert imgs.shape == (16, 960, 1280)
    plan = make_plan(960, 1280, cfg)
    octaves = tpyr._build_pyramid(imgs.contiguous(), plan, cfg)
    want0 = conv.octave_chain_plain(octaves[0][:, 0].contiguous(),
                                    gaussian.chain_taps(p))
    assert torch.equal(octaves[0], want0)
    nh, nw = plan.octave_shapes[1]
    lds = p.level_ds - p.level_min
    assert torch.equal(octaves[1][:, 0],
                       conv.downsample2_plain(want0[:, lds])[..., :nh, :nw])
    args = (octaves[0], tpyr._detect_norms(p, cfg), p.key_levels)
    kw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
              subpixel=True, darkness_adaption=False, detector="dog")
    gm, ggrad, grot = detect.detect_octave(*args, **kw)
    wm, wgrad, wrot = detect.detect_octave_plain(*args, **kw)
    assert torch.equal(gm.valid, wm.valid) and int(wm.valid.sum()) > 1000
    for f in ("response", "dx", "dy", "ds", "ftype"):
        assert torch.equal(getattr(gm, f)[wm.valid],
                           getattr(wm, f)[wm.valid]), f
    torch.testing.assert_close(ggrad, wgrad, rtol=1e-6, atol=0)
    torch.testing.assert_close(grot, wrot, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_patch_kernels_read_band_maps_through_their_row_origin(card, n):
    """The key levels' maps of a 256-row octave cut into n bands of rows
    plus `halo` rows (edge rows repeated past the borders), each band read
    through its row origin: both kernels give the whole maps' results bit
    for bit (the same pixels in the same order), on keypoints at every band
    border with sigmas up to the largest a keypoint may have, whose support
    the spatial path's halo covers."""
    cfg, t, maps, owin, dwin = _keypoint_scene(card, (1, 256, 200),
                                               "hessian", threshold=0.002)
    grad, rot = maps.grad[0], maps.rot[0]                # (1, 3, 256, 200)
    p = cfg.scale_params()
    max_sigma = p.key_level_sigma(p.key_levels[-1]) * p.sigmak
    halo, hl = (max(owin, dwin) - 1) // 2 + 2, 256 // n   # spatial.py's
    pad = lambda a: torch.cat([a[..., :1, :].expand(1, 3, halo, 200), a,
                               a[..., -1:, :].expand(1, 3, halo, 200)], -2)
    bands = lambda a: torch.stack([pad(a)[0, :, s * hl:s * hl + hl + 2 * halo]
                                   for s in range(n)])
    whole = type(maps)((grad.expand(n, 3, 256, 200).contiguous(),),
                       (rot.expand(n, 3, 256, 200).contiguous(),))
    banded = type(maps)((bands(grad),), (bands(rot),), (-halo,), (hl,),
                        (256,))
    rng = np.random.RandomState(n)
    G = 32
    rows = np.stack([s * hl + np.concatenate([
        rng.uniform(0, 3, 8), rng.uniform(hl - 3, hl, 8),
        rng.uniform(0, hl, 16)]) for s in range(n)]).astype(np.float32)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    x, y = f32(rng.uniform(1, 199, (n, G))), f32(rows)
    sigma = f32(rng.uniform(1.5, max_sigma, (n, G)))
    valid = torch.ones((n, G), dtype=torch.bool, device=card)
    lid = torch.from_numpy(rng.randint(0, 3, (n, G)).astype(np.int32)) \
        .to(card)
    a = patch.orientation(x, y, sigma, valid, lid, whole, owin,
                          return_votes=True)
    b = patch.orientation(x, y, sigma, valid, lid, banded, owin,
                          return_votes=True)
    for u, v in zip(a, b):
        assert u is None or torch.equal(u, v)
    theta = a.thetas[..., 0].contiguous()
    da = patch.descriptor(x, y, sigma, theta, valid, lid, whole, dwin)
    db = patch.descriptor(x, y, sigma, theta, valid, lid, banded, dwin)
    assert torch.equal(da, db) and bool(da.abs().sum() > 0)
    # and the plain versions read the bands alike
    pb = patch.descriptor_plain(x, y, sigma, theta, valid, lid, banded, dwin)
    scale = pb.abs().amax((-2, -1), keepdim=True).clamp_min(1e-30)
    assert float(((db - pb).abs() / scale).max()) <= VOTE_TOL


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_path_goes_through_the_kernels(card, n):
    """sharded_detect_and_describe on an in-process mesh of n bands of a
    512x256 texture: launches of blur, downsample2, detect_octave and one
    orientation and one descriptor launch, no chain; the table equal to
    the same path through the plain versions on the card (keypoints bit
    for bit, descriptors within 2e-6) and to one-device
    detect_and_describe (bit for bit), no shard's level cap being full."""
    from hessgpu_tpu_torch import detect_and_describe
    from hessgpu_tpu_torch.parallel.distributed import local_mesh
    from hessgpu_tpu_torch.parallel.spatial import sharded_detect_and_describe
    img = texture_frame(7, 512, 256)
    cfg = SiftConfig()
    with disable_graphs():      # the eager route: its wrappers count launches
        reset_launch_counts()
        eager, aux = sharded_detect_and_describe(img, cfg, local_mesh(n),
                                                 with_aux=True)
        counts = launch_counts()
    assert counts["octave_chain"] == 0 and counts["orientation"] == 1 \
        and counts["descriptor"] == 1
    assert min(counts["blur"], counts["downsample2"],
               counts["detect_octave"]) > 0
    assert not bool((aux["shard_level_counts"] >= aux["level_cap"]).any())
    got = sharded_detect_and_describe(img, cfg, local_mesh(n))   # the graph
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(eager, f)), f
    want = sharded_detect_and_describe(img, cfg, local_mesh(n), plain=True)
    one, _ = detect_and_describe(img, cfg)
    assert int(got.valid.sum()) > 50
    for f in got._fields:
        if f != "desc":
            assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert torch.equal(getattr(got, f), getattr(one, f)), f
    assert float((got.desc - want.desc).abs().max()) <= 2e-6
    assert torch.equal(got.desc, one.desc)


# ---- the feature-list kernels (csrc/compact.cu) -----------------------------

def _dot_rows(h=96, w=640, step=8, rows=(24, 48, 72), seed=0):
    """tests/test_torch_pipeline.py's row-cap flood: rows of dark Gaussian
    dots `step` px apart on a faintly noisy grey, far more keypoints in one
    row of octave 0 than the per-row cap keeps."""
    rng = np.random.RandomState(seed)
    img = 0.6 + 0.02 * rng.rand(h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    for r in rows:
        for c in range(step // 2 + 3, w - 3, step):
            cy, cx = r + rng.uniform(-0.3, 0.3), c + rng.uniform(-0.3, 0.3)
            img -= (0.5 + 0.1 * rng.rand()) \
                * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    return img.astype(np.float32)


def _feature_lists(maps, caps, G, sigmas, step, level_ids):
    """GENERATE_FEATURE_LIST over the same maps on the card's route
    (compact_octave + feature_table) and on the plain route
    (compact_octave_keypoints + _globalize), and the card route's
    launches."""
    from hessgpu_tpu_torch.ops import compaction as tcomp
    from hessgpu_tpu_torch.ops.cuda import compact as kcompact
    reset_launch_counts()
    got = kcompact.feature_table(
        [kcompact.compact_octave(m, sigmas, step, c)
         for m, c in zip(maps, caps)], G, level_ids)
    launches = launch_counts()
    want = kcompact.feature_table_plain(
        [tcomp.compact_octave_keypoints(m, sigmas, step, c)
         for m, c in zip(maps, caps)], G, level_ids)
    return got, want, launches


def _pipeline_feature_lists(imgs, cfg):
    """_feature_lists over the detect kernel's maps of a batch (B, H, W)."""
    _, h, w = imgs.shape
    plan = make_plan(h, w, cfg)
    p = cfg.scale_params()
    nk = len(p.key_levels)
    consts = tpyr._plan_constants(plan, cfg, imgs.device)
    octaves = tpyr._build_pyramid(imgs.contiguous(), plan, cfg)
    maps = [tpyr._detect_octave(g, cfg)[0] for g in octaves]
    G = min(cfg.global_feature_cap, sum(plan.level_caps))
    caps = [plan.level_caps[o * nk] for o in range(plan.num_octaves)]
    got, want, launches = _feature_lists(maps, caps, G, consts.key_sigmas,
                                         p.sigmak, consts.level_ids)
    assert launches["row_counts"] == plan.num_octaves
    assert launches["level_scan"] == launches["table_scatter"] == 1
    return got, want, plan, maps


def _assert_feature_lists_equal(got, want):
    (table, counts, pre), (wtable, wcounts, wpre) = got, want
    for f in table._fields:
        a, b = getattr(table, f), getattr(wtable, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    for a, b in ((counts, wcounts), (pre, wpre)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


FEATURE_LIST_CASES = {
    "640x480-b16": ((16, 480, 640), {}),
    "dog-640x480-b16": ((16, 480, 640), dict(detector="dog")),
    "sd-ofix-640x480-b16": ((16, 480, 640), SLICE),
    "level-cap": ((4, 480, 640), dict(threshold=0.0005,
                                      max_level_features=32)),
    "table-cap": ((4, 480, 640), dict(global_feature_cap=64)),
    "odd-shapes": ((3, 101, 75), {}),
    "4032x6048": ((1, 4032, 6048), {}),
}


@pytest.mark.parametrize("case", sorted(FEATURE_LIST_CASES))
def test_feature_list_kernels_equal_plain(card, case):
    """The table, level counts and count of the feature-list kernels equal
    the plain route's on the same maps, every field bit for bit (sigma
    included: the kernel's powf is PyTorch's CUDA pow)."""
    shape, kw = FEATURE_LIST_CASES[case]
    cfg = SiftConfig(**kw)
    imgs = _texture_batch(shape, card)
    got, want, plan, _ = _pipeline_feature_lists(imgs, cfg)
    _assert_feature_lists_equal(got, want)
    counts, pre = want[1], want[2]
    G = want[0].x.shape[-1]
    assert int(pre.min()) > 0
    if case == "level-cap":
        caps = torch.tensor(plan.level_caps, device=card)
        assert bool((counts == caps).any())
    if case == "table-cap":
        assert int(pre.max()) == G < int(counts.sum(-1).max())


def test_feature_list_kernels_under_a_row_cap_flood(card):
    """The row-cap flood of the CPU tests: octave 0 rows hold more valid
    cells than the per-row cap, which decides the kernels' membership as
    the plain route's."""
    from hessgpu_tpu_torch.ops.compaction import _row_cap
    imgs = torch.from_numpy(np.stack([_dot_rows(), _dot_rows(seed=1)])) \
        .to(card)
    got, want, _, maps = _pipeline_feature_lists(imgs, SiftConfig())
    _assert_feature_lists_equal(got, want)
    per_row = maps[0].valid.sum(-1)
    assert int(per_row.max()) > min(640, _row_cap(640))


def test_feature_list_batched_equals_per_image(card):
    imgs = _texture_batch((4, 480, 640), card)
    cfg = SiftConfig()
    (table, counts, pre), _, _, _ = _pipeline_feature_lists(imgs, cfg)
    for i in range(4):
        (t1, c1, p1), _, _, _ = _pipeline_feature_lists(imgs[i:i + 1], cfg)
        for a, b in zip(table, t1):
            assert torch.equal(a[i:i + 1], b)
        assert torch.equal(counts[i:i + 1], c1)
        assert torch.equal(pre[i:i + 1], p1)


def test_feature_list_sigma_over_many_offsets(card):
    """3.1 M kept cells of synthetic maps, ds uniform in (-1, 1) and a few
    exact values, rows 2040 bytes long (every other row starts mid-chunk)
    and half valid, so each row's cap (63) decides: the kernels' table
    equals the plain route's, sigma = key_sigma * pow(step, ds) bit for
    bit."""
    rng = np.random.RandomState(11)
    shape = (64, 3, 256, 2040)
    ds = rng.uniform(-1, 1, shape).astype(np.float32)
    ds[..., :4] = np.float32([0.0, 0.5, -0.5, 2.0 ** -20])
    u = lambda: torch.from_numpy(   # noqa: E731
        rng.uniform(-0.95, 0.95, shape).astype(np.float32)).to(card)
    from hessgpu_tpu_torch.ops.keypoint import KeypointMaps
    maps = KeypointMaps(
        valid=torch.from_numpy(rng.rand(*shape) < 0.5).to(card),
        response=u(), dx=u(), dy=u(), ds=torch.from_numpy(ds).to(card),
        ftype=torch.from_numpy(rng.randint(0, 3, shape).astype(np.int32))
        .to(card))
    cap = 256 * 63
    sigmas = torch.tensor([2.0159, 2.5398, 3.2], dtype=torch.float32,
                          device=card)
    level_ids = torch.arange(3, dtype=torch.int32,
                             device=card).repeat_interleave(cap)
    got, want, _ = _feature_lists([maps], [cap], 3 * cap, sigmas,
                                  2.0 ** (1.0 / 3.0), level_ids)
    _assert_feature_lists_equal(got, want)
    assert int(want[2].min()) == 3 * cap


def test_captured_pipeline_holds_the_feature_list_kernels(card):
    """A captured detect_batch holds the feature-list kernels' launches, and
    under -sd -ofix (no orientation expansion, whose compaction stays
    PyTorch) its trace holds no PyTorch scan or binary search."""
    from hessgpu_tpu_torch.utils.timing import device_profile
    imgs = _texture_batch((16, 480, 640), card)
    for kw in ({}, SLICE):
        cfg = SiftConfig(**kw)
        detect_batch(imgs, cfg)
        st = tpyr._PIPELINE_GRAPHS.stats()[-1]
        n_oct = make_plan(480, 640, cfg).num_octaves
        assert (st.launches["row_counts"], st.launches["level_scan"],
                st.launches["table_scatter"]) == (n_oct, 1, 1)
    names = list(device_profile(detect_batch, imgs, SiftConfig(**SLICE))
                 ["by_kernel"])
    for sym in ("row_count_kernel", "level_scan_kernel",
                "table_scatter_kernel"):
        assert any(sym in n for n in names), (sym, names)
    assert not any("searchsorted" in n for n in names), names
    assert not any("scan" in n and "level_scan_kernel" not in n
                   for n in names), names


# ---- the small-SVD kernels of the RANSAC cores -------------------------------

def _design_batch(b, m, seed):
    """Hartley-normalised eight-point rows of b seeded m-point samples."""
    from hessgpu_tpu_torch.sfm import twoview as ttv
    rng = np.random.RandomState(seed)
    p1 = torch.from_numpy(rng.uniform(0, 640, (b, m, 2)).astype(np.float32))
    p2 = p1 + torch.from_numpy(rng.normal(0, 20, (b, m, 2)).astype(
        np.float32))
    n1, _ = ttv._normalize_points(p1)
    n2, _ = ttv._normalize_points(p2)
    return ttv._design(n1, n2)


def _null_vector_inputs():
    rng = np.random.RandomState(3)
    degenerate = _design_batch(4, 8, 4)
    degenerate[0, 5] = degenerate[0, 2]           # a repeated draw
    degenerate[1] = 0.0
    degenerate[2, 4:] = degenerate[2, :4]
    return {"eight_point_512x8x9": _design_batch(512, 8, 1),
            "refit_428x9": _design_batch(1, 428, 2)[0],
            "refit_2048x9": _design_batch(1, 2048, 5),
            "dlt_256x12x12": torch.from_numpy(
                rng.randn(256, 12, 12).astype(np.float32)),
            "batch_64x16x12": torch.from_numpy(
                rng.randn(64, 16, 12).astype(np.float32)),
            "degenerate_4x8x9": degenerate}


def _sweeps_of(A):
    return torch.zeros(A.shape[:-2], dtype=torch.int32, device=A.device)


@pytest.mark.parametrize("case", list(_null_vector_inputs()))
def test_null_vector_kernel_equals_plain(card, case):
    """Bit for bit, the sweeps each matrix ran too."""
    A = _null_vector_inputs()[case].to(card)
    sweeps = _sweeps_of(A)
    reset_launch_counts()
    got = cuda_linalg.null_vector(A, sweeps=sweeps)
    want, (want_sweeps, _) = linalg.null_vector_plain(A, return_counts=True)
    assert launch_counts()["null_vector"] == 1     # the plain launched none
    assert got.shape == want.shape and torch.equal(got, want)
    assert not bool(got.isnan().any())
    assert torch.equal(sweeps, want_sweeps)
    assert 1 <= int(sweeps.min()) and \
        int(sweeps.max()) <= linalg.NULL_VECTOR_SWEEPS


@pytest.mark.parametrize("max_sweeps", [0, 1, 3])
def test_null_vector_kernel_under_a_cap_equals_plain(card, max_sweeps):
    """A cap below the convergence stop: every matrix runs the cap, and the
    kernel still equals its plain version."""
    A = _null_vector_inputs()["dlt_256x12x12"].to(card)
    sweeps = _sweeps_of(A)
    got = cuda_linalg.null_vector(A, max_sweeps=max_sweeps, sweeps=sweeps)
    want, (want_sweeps, _) = linalg.null_vector_plain(
        A, max_sweeps=max_sweeps, return_counts=True)
    assert torch.equal(got, want) and torch.equal(sweeps, want_sweeps)
    assert bool((sweeps == max_sweeps).all())


def test_null_vector_kernel_freezes_what_converged(card):
    """Matrices that stop after different sweeps share warps: each gives
    bit for bit what it gives alone (the zero matrix stops after 1 sweep,
    its warp partner runs on)."""
    inputs = _null_vector_inputs()
    A = torch.cat([inputs["degenerate_4x8x9"],
                   inputs["eight_point_512x8x9"][:5]]).to(card)
    sweeps = _sweeps_of(A)
    got = cuda_linalg.null_vector(A, sweeps=sweeps)
    assert len(set(sweeps.tolist())) >= 3
    for i in range(len(A)):
        alone = _sweeps_of(A[i:i + 1])
        assert torch.equal(cuda_linalg.null_vector(A[i:i + 1], sweeps=alone),
                           got[i:i + 1])
        assert torch.equal(alone, sweeps[i:i + 1])


def _svd3_inputs():
    rng = np.random.RandomState(6)
    degenerate = torch.zeros(4, 3, 3)
    degenerate[1] = torch.tensor([[1.0, 2, 3], [4, 5, 9], [7, 8, 15]])
    degenerate[2] = torch.tensor([[1.0, 2, 3], [2, 4, 6], [3, 6, 9]])
    degenerate[3] = torch.eye(3)
    return {"512x3x3": torch.from_numpy(rng.randn(512, 3, 3).astype(
        np.float32)), "3x3": torch.from_numpy(rng.randn(3, 3).astype(
            np.float32)), "256x3x3": torch.from_numpy(rng.randn(
                256, 3, 3).astype(np.float32)), "degenerate": degenerate}


@pytest.mark.parametrize("case", list(_svd3_inputs()))
def test_svd3_kernel_equals_plain(card, case):
    """Bit for bit, the sweeps each matrix ran too."""
    A = _svd3_inputs()[case].to(card)
    sweeps = _sweeps_of(A)
    reset_launch_counts()
    got = cuda_linalg.svd3(A, sweeps=sweeps)
    *want, (want_sweeps, _) = linalg.svd3_plain(A, return_counts=True)
    assert launch_counts()["svd3"] == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
        assert not bool(g.isnan().any())
    assert torch.equal(sweeps, want_sweeps)
    assert int(sweeps.max()) <= linalg.SVD3_SWEEPS


def test_svd3_kernel_under_a_cap_equals_plain(card):
    A = _svd3_inputs()["512x3x3"].to(card)
    sweeps = _sweeps_of(A)
    got = cuda_linalg.svd3(A, max_sweeps=1, sweeps=sweeps)
    *want, (want_sweeps, _) = linalg.svd3_plain(A, max_sweeps=1,
                                                return_counts=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(sweeps, want_sweeps) and bool((sweeps == 1).all())


def test_ransac_cores_launch_their_kernels(card):
    """On a CUDA tensor the cores go through the kernels, eagerly: two
    null_vector and two svd3 launches a fundamental RANSAC, one each a
    PnP."""
    from hessgpu_tpu_torch.sfm import twoview as ttv
    rng = np.random.RandomState(8)
    n = 300
    X = rng.uniform(-1, 1, (n, 3)) * [3, 2, 1] + [0, 0, 6]
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    a = 0.1
    R2 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    Xc = X @ R2.T + [-0.5, 0.0, 0.0]
    uv = X[:, :2] / X[:, 2:] * 600.0 + K[:2, 2]
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                    device=card)
    p1 = f32(uv + rng.normal(0, 0.3, uv.shape))
    p2 = f32(Xc[:, :2] / Xc[:, 2:] * 600.0 + K[:2, 2]
             + rng.normal(0, 0.3, uv.shape))
    valid = torch.ones(n, dtype=torch.bool, device=card)
    fidx = torch.as_tensor(rng.randint(0, n, (512, 8)), device=card)
    pidx = torch.as_tensor(rng.randint(0, n, (256, 6)), device=card)
    with disable_graphs():
        reset_launch_counts()
        fres = ttv.ransac_fundamental_from_samples(fidx, p1, p2, valid)
        pres = ttv.ransac_pnp_from_samples(pidx, f32(X), f32(uv), valid,
                                           f32(K))
        counts = launch_counts()
    assert (counts["null_vector"], counts["svd3"]) == (3, 3)
    assert int(fres.num_inliers) >= 250 and int(pres.num_inliers) >= 250
