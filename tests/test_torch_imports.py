"""What the port imports, where it runs, and what it refuses."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hessgpu_tpu_torch as ht
from hessgpu_tpu_torch.ops.cuda import build, conv, detect
from hessgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from hessgpu_tpu_torch.ops.resize import upsample
from hessgpu_tpu_torch.sfm.synthetic import texture_frame
from _torch_threads import one_torch_thread  # noqa: F401

SLICE = dict(compute_descriptors=False, fixed_orientation=True)
REPO = Path(__file__).resolve().parents[1]
EXAMPLES = str(REPO / "examples")


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    """The package, the example (examples/simple_sift_torch.py) and
    chip_smoke.py (which imports the port inside its phases; at import it
    takes the standard library only)."""
    code = (
        "import sys\n"
        "import hessgpu_tpu_torch\n"
        "import hessgpu_tpu_torch.convert, hessgpu_tpu_torch.parallel.batch\n"
        "import hessgpu_tpu_torch.ops.cuda.conv\n"
        "import hessgpu_tpu_torch.ops.cuda.detect\n"
        "import hessgpu_tpu_torch.ops.cuda.patch\n"
        "import hessgpu_tpu_torch.ops.cuda.linalg\n"
        "import hessgpu_tpu_torch.ops.linalg\n"
        "import hessgpu_tpu_torch.ops.gather\n"
        "import hessgpu_tpu_torch.ops.orientation\n"
        "import hessgpu_tpu_torch.ops.descriptor\n"
        "import hessgpu_tpu_torch.describe\n"
        "import hessgpu_tpu_torch.detector, hessgpu_tpu_torch.matcher\n"
        "import hessgpu_tpu_torch.formats, hessgpu_tpu_torch.io_image\n"
        "import hessgpu_tpu_torch.native, hessgpu_tpu_torch.evaluation\n"
        "import hessgpu_tpu_torch.features, hessgpu_tpu_torch.ops.resize\n"
        "import hessgpu_tpu_torch.utils.timing, hessgpu_tpu_torch.utils.viz\n"
        "import hessgpu_tpu_torch.cli.hess\n"
        "import hessgpu_tpu_torch.utils.precision\n"
        "import hessgpu_tpu_torch.utils.graphs\n"
        "import hessgpu_tpu_torch.sfm.ba, hessgpu_tpu_torch.sfm.twoview\n"
        "import hessgpu_tpu_torch.sfm.posegraph\n"
        "import hessgpu_tpu_torch.sfm.incremental, hessgpu_tpu_torch.sfm.io\n"
        "import hessgpu_tpu_torch.sfm.datasets\n"
        "import hessgpu_tpu_torch.sfm.evaluate\n"
        "import hessgpu_tpu_torch.sfm.synthetic\n"
        "import hessgpu_tpu_torch.server_backend\n"
        "import hessgpu_tpu_torch.server_build\n"
        "import hessgpu_tpu_torch.parallel.client\n"
        "import hessgpu_tpu_torch.parallel.distributed\n"
        "import hessgpu_tpu_torch.parallel.spatial\n"
        "import hessgpu_tpu_torch.sfm.distributed_ba\n"
        "import hessgpu_tpu_torch.entry\n"
        f"sys.path.insert(0, {EXAMPLES!r})\n"
        "import simple_sift_torch\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'hessgpu_tpu'"
        " or m.startswith('hessgpu_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'PIL' not in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_the_port_exports_the_jax_packages_public_names():
    """Every name of hessgpu_tpu.__all__ (read from its source, not
    imported) is public in the port, ScaleSpaceParams among them."""
    import ast
    src = REPO / "hessgpu_tpu" / "__init__.py"
    names = next(ast.literal_eval(node.value)
                 for node in ast.parse(src.read_text()).body
                 if isinstance(node, ast.Assign)
                 and [t.id for t in node.targets] == ["__all__"])
    assert "ScaleSpaceParams" in names
    for name in names:
        assert name in ht.__all__ and hasattr(ht, name), name
    from hessgpu_tpu_torch.params import ScaleSpaceParams
    assert ht.ScaleSpaceParams is ScaleSpaceParams


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
    dict(detector="dog", first_octave=-1),               # upsampled octave
    dict(conv_mode="direct"),
], ids=["default", "orientation", "descriptors", "first_octave", "direct"])
def test_unported_configs_raise(kw):
    """No configuration raises any more (the name is kept from when these
    did): each of these once raised NotImplementedError and now runs, through detect_and_describe and
    detect_batch alike, and returns real orientations and descriptors where
    it asks for them. detect_batch takes the octave input as given (it
    neither upsamples nor subsamples, as the JAX package's batch entry), so
    at first_octave < 0 it is fed the upsampled frame."""
    cfg = ht.SiftConfig(**kw)
    img = texture_frame(2, 96, 128)
    one, _ = ht.detect_and_describe(img, cfg, device="cpu")
    x = torch.from_numpy(img)
    if cfg.first_octave < 0:
        x = upsample(x, -cfg.first_octave)
    batch = ht.detect_batch(x[None], cfg, device="cpu")
    assert int(one.count()) >= 3
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])
    v = one.valid
    assert bool(one.theta[v].any()) == (not cfg.fixed_orientation)
    assert bool((one.desc[v].abs().amax(-1) > 0).all()) \
        == cfg.compute_descriptors
    assert not bool(one.desc[~v].any()) and not bool(one.theta[~v].any())
    keys = ht.to_numpy_trimmed(one)
    out = ht.describe_keypoints(
        img, np.stack([keys["x"], keys["y"], keys["sigma"]], 1), cfg,
        has_orientation=False, device="cpu")
    assert np.isfinite(out["desc"]).all() and out["desc"].any()


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
                               "orientation": 0, "descriptor": 0,
                               "null_vector": 0, "svd3": 0,
                               "row_counts": 0, "level_scan": 0,
                               "table_scatter": 0}


def test_sources_are_in_the_package():
    names = sorted(p.name for p in build.sources())
    assert names == ["compact.cu", "conv.cu", "detect.cu", "linalg.cu",
                     "patch.cu"]
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)


def test_the_server_source_imports_only_the_port():
    """The port's hess_server embeds Python and imports the port's modules,
    never the JAX package's."""
    import re
    from hessgpu_tpu_torch import server_build
    src = server_build.SOURCE.read_text()
    names = re.findall(r"(?:import|from)\s+([A-Za-z_][\w.]*)", src) \
        + re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', src)
    ours = [n for n in names if n.startswith("hessgpu")]
    assert ours and all(n.split(".")[0] == "hessgpu_tpu_torch" for n in ours)
    assert "jax" not in names and "hessgpu_tpu.server_backend" not in src
