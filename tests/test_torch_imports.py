"""What the port imports, where it runs, and what it refuses."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import hessgpu_tpu_torch as ht
from hessgpu_tpu_torch.ops.cuda import build, conv, detect
from hessgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from hessgpu_tpu_torch.pyramid import check_supported
from hessgpu_tpu_torch.sfm.synthetic import texture_frame

SLICE = dict(compute_descriptors=False, fixed_orientation=True)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import hessgpu_tpu_torch\n"
        "import hessgpu_tpu_torch.convert, hessgpu_tpu_torch.parallel.batch\n"
        "import hessgpu_tpu_torch.ops.cuda.conv\n"
        "import hessgpu_tpu_torch.ops.cuda.detect\n"
        "import hessgpu_tpu_torch.ops.cuda.patch\n"
        "import hessgpu_tpu_torch.ops.gather\n"
        "import hessgpu_tpu_torch.ops.orientation\n"
        "import hessgpu_tpu_torch.ops.descriptor\n"
        "import hessgpu_tpu_torch.describe\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'hessgpu_tpu'"
        " or m.startswith('hessgpu_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_import_builds_and_loads_nothing():
    """Kernels are built at first launch, not at import."""
    assert build._lib is None
    assert build.build_seconds is None


@pytest.mark.parametrize("entry", ["detect_batch", "detect_and_describe"])
def test_cuda_without_a_card_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ht.SiftConfig()
    img = np.zeros((32, 40), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "detect_batch":
            ht.detect_batch(img[None], cfg)            # device defaults to cuda
        else:
            ht.detect_and_describe(img, cfg)


@pytest.mark.parametrize("kw", [
    dict(),                                              # the default config
    dict(compute_descriptors=False),                     # orientations
    dict(fixed_orientation=True),                        # descriptors
    dict(SLICE, detector="dog", first_octave=-1),        # upsampled octave
    dict(SLICE, conv_mode="direct"),
], ids=["default", "orientation", "descriptors", "first_octave", "direct"])
def test_unported_configs_raise(kw):
    """What the port does not cover raises; the configurations that did so
    before the per-keypoint stages were ported now run, and return real
    orientations and descriptors."""
    cfg = ht.SiftConfig(**kw)
    img = texture_frame(2, 96, 128)
    if cfg.first_octave < 0 or cfg.conv_mode != "chain":
        with pytest.raises(NotImplementedError, match="does not port"):
            check_supported(cfg)
        with pytest.raises(NotImplementedError):
            ht.detect_and_describe(img, cfg, device="cpu")
        with pytest.raises(NotImplementedError):
            ht.detect_batch(img[None], cfg, device="cpu")
        with pytest.raises(NotImplementedError):
            ht.describe_keypoints(img, np.array([[20.0, 20.0, 2.0]]), cfg,
                                  device="cpu")
        return
    check_supported(cfg)
    one, _ = ht.detect_and_describe(img, cfg, device="cpu")
    batch = ht.detect_batch(img[None], cfg, device="cpu")
    assert int(one.count()) >= 3
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])
    v = one.valid
    assert bool(one.theta[v].any()) == (not cfg.fixed_orientation)
    assert bool((one.desc[v].abs().amax(-1) > 0).all()) \
        == cfg.compute_descriptors
    assert not bool(one.desc[~v].any()) and not bool(one.theta[~v].any())


def test_hessian_clamps_a_negative_first_octave():
    """The Hessian personality restricts first_octave to >= 0 (reference
    SiftGPU.cpp:1166-1170), so -fo -1 runs there and equals -fo 0."""
    rng = np.random.RandomState(0)
    img = rng.rand(48, 64).astype(np.float32)
    a, _ = ht.detect_and_describe(img, ht.SiftConfig(**SLICE, first_octave=-1),
                                  device="cpu")
    b, _ = ht.detect_and_describe(img, ht.SiftConfig(**SLICE), device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cpu_runs_count_no_launches():
    """A wrapper counts where it launches its kernel and nowhere else: the
    plain versions on CPU tensors leave every count at 0."""
    reset_launch_counts()
    img = np.random.RandomState(1).rand(1, 40, 48).astype(np.float32)
    ht.detect_batch(img, ht.SiftConfig(**SLICE), device="cpu")
    ht.detect_batch(img, ht.SiftConfig(), device="cpu")
    ht.describe_keypoints(img[0], np.array([[20.0, 20.0, 2.0]]), device="cpu")
    assert launch_counts() == {"blur": 0, "octave_chain": 0,
                               "downsample2": 0, "detect_octave": 0,
                               "orientation": 0, "descriptor": 0}


def test_sources_are_in_the_package():
    names = sorted(p.name for p in build.sources())
    assert names == ["conv.cu", "detect.cu", "patch.cu"]
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)
