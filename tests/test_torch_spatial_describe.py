"""The port's row-sharded detect + describe (hessgpu_tpu_torch/parallel/
spatial.py sharded_detect_and_describe) on the CPU against the JAX
package's on its 2- and 8-device virtual CPU meshes (tests/conftest.py), at
tests/test_spatial.py's shapes and seeds; the port's mesh is the in-process
one (local_mesh). The filters, the keypoints alone and the row origin are
in test_torch_spatial.py (two files, so that parallel workers share the
JAX package's compiles).

Tolerances: the port's end-to-end ones against the JAX package
(tests/test_torch_pipeline_default.py): the same features in the same
order; x, y, sigma within 1e-3 px per octave scale, response within 2^-10
relative, level and ftype equal, theta equal (one 2pi/255 quantum allowed
on 1% of the features), descriptors within 5e-4. One keypoint of the
256x320 image has an ill-conditioned subpixel solve and lands 1.2e-3 px
from the JAX package's (on one device too): one keypoint, or its two
features, may exceed the position and descriptor tolerances by at most 20x,
as that file allows on its DoG frame. Against the port's own one-device
detect_and_describe: bit-equal, field for field, where no shard's level cap
is full; the overflow case (a per-shard cap of c // n + 8 reached) is held
to the JAX package's membership.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest

from hessgpu_tpu.config import SiftConfig as JConfig, TRUNCATE_TOP_K
from hessgpu_tpu.parallel import spatial as jsp
from hessgpu_tpu_torch import detect_and_describe
from hessgpu_tpu_torch.config import SiftConfig
from hessgpu_tpu_torch.parallel import spatial as tsp
from hessgpu_tpu_torch.parallel.distributed import local_mesh

from test_torch_pipeline import _np_table, _torch_table
from test_torch_pipeline_default import _assert_features_agree
from test_torch_spatial import _jax_mesh, _smooth_image
from _torch_graph_route import graph_route  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


_DESCRIBE_CASES = {
    "512x192_topk": (512, 192, dict(max_level_features=256,
                                    truncate_method=TRUNCATE_TOP_K,
                                    feature_count_threshold=40)),
    "256x320": (256, 320, {}),
    "512x192_overflow": (512, 192, dict(max_level_features=32)),
}


@functools.lru_cache(maxsize=None)
def _jax_table(n, case):
    """The JAX package's sharded program over n virtual devices, run once
    per process for the cases that hold the port to it."""
    h, w, kw = _DESCRIBE_CASES[case]
    return _np_table(jsp.sharded_detect_and_describe(
        jnp.asarray(_smooth_image(h, w)), JConfig(threshold=0.001, **kw),
        _jax_mesh(n)))


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", list(_DESCRIBE_CASES))
def test_sharded_detect_and_describe_matches_jax(n, case):
    _check_against_jax(n, case)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", list(_DESCRIBE_CASES))
def test_the_captured_sharded_program_matches_jax(n, case, graph_route):
    """The function a card captures on an in-process mesh (the sharded
    pipeline, the level-major gather and the table's assembly as one
    graph, _sharded_program), run here by the graph_route fixture."""
    _check_against_jax(n, case)
    assert [c.cache for c in graph_route] == [tsp._SPATIAL_GRAPHS]


def _check_against_jax(n, case):
    h, w, kw = _DESCRIBE_CASES[case]
    img = _smooth_image(h, w)
    tc = SiftConfig(threshold=0.001, **kw)
    want = _jax_table(n, case)
    table, aux = tsp.sharded_detect_and_describe(
        img, tc, local_mesh(n), device="cpu", with_aux=True)
    got = _torch_table(table)
    assert got["x"].shape == want["x"].shape
    _assert_features_agree(got, want, min_count=20, loose=2)

    full = aux["shard_level_counts"] >= aux["level_cap"]
    if case.endswith("overflow"):
        assert bool(full.any()), "the case must overflow a shard's level cap"
        return
    assert not bool(full.any())
    one = _torch_table(detect_and_describe(img, tc, device="cpu")[0])
    for f in one:
        np.testing.assert_array_equal(got[f], one[f], err_msg=f)
