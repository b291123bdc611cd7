"""The port's entry points (hessgpu_tpu_torch/entry.py, the
counterpart of __graft_entry__.py) on the CPU: the one-image forward step,
and dryrun_multichip's five multi-device steps on an 8-shard in-process
mesh at the JAX package's dry-run sizes. The dry run's feature counts equal
the port's mesh=None batch (bit-equal paths); the JAX package's dry run
only reports, so there is no JAX yardstick beyond the files that hold each
step (test_torch_batch_mesh.py, test_torch_distributed.py,
test_torch_spatial.py, test_torch_distributed_ba.py).
"""

import numpy as np
import pytest
import torch

from hessgpu_tpu_torch import SiftConfig, detect_batch
from hessgpu_tpu_torch import entry as tentry
from hessgpu_tpu_torch.parallel.distributed import local_mesh, match_sharded
from _torch_threads import one_torch_thread  # noqa: F401


def test_dryrun_multichip_on_eight_shards(capsys):
    out = tentry.dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8): ok" in capsys.readouterr().out
    imgs = np.stack([tentry._make_image(64, 64, seed=i) for i in range(8)])
    want = detect_batch(imgs, SiftConfig(max_level_features=64),
                        device="cpu").count().tolist()
    assert out["counts"] == want
    d1 = np.random.RandomState(0).randint(0, 100, (8 * 16, 128)) \
        .astype(np.uint8)
    assert out["matches"] == int((match_sharded(d1, d1, device="cpu")
                                  >= 0).sum())
    assert np.isfinite(out["ba_cost"]) and out["spatial_count"] >= 0


def test_the_module_runs_the_dry_run(capsys):
    tentry.main(["--device", "cpu", "--shards", "2"])
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out


def test_a_mesh_of_another_size_is_refused():
    with pytest.raises(ValueError, match="shards"):
        tentry.dryrun_multichip(4, mesh=local_mesh(2), device="cpu")


def test_entry_is_a_one_image_forward():
    fn, (img,) = tentry.entry(device="cpu")
    x, y, sigma, theta, desc, valid = fn(img)
    assert img.shape == (480, 640) and desc.shape == (x.shape[0], 128)
    assert int(valid.sum()) > 0 and bool(torch.isfinite(desc).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tentry.entry()                       # device defaults to cuda
