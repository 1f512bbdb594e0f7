"""The loader's host profile (``utils/profile_loader.py``): it times every
part of a sample, leaves the loader as it found it, and the loader it times
packs the batches an untimed one packs."""

from __future__ import annotations

import numpy as np
import pytest

from vision_assist_tpu_torch.data import augment, loader
from vision_assist_tpu_torch.data.augment import AugmentConfig
from vision_assist_tpu_torch.io.synthetic import WalkwaySet
from vision_assist_tpu_torch.utils import profile_loader as pl

AUG = AugmentConfig(copy_paste=0.5, degrees=5.0)


@pytest.fixture(scope="module")
def ds():
    return WalkwaySet(8, 96, 128, seed=5)


def test_profile_times_every_part_and_restores_the_loader(ds):
    before = {n: getattr(loader, n) for n in pl.TOP_PARTS}
    before.update({n: getattr(augment, n) for n in pl.INNER_PARTS})
    pack = loader.BatchLoader._pack
    workers = (2, 1)
    out = pl.profile(ds, 64, 4, workers, repeat=3, aug=AUG)
    assert all(getattr(loader, n) is before[n] for n in pl.TOP_PARTS)
    assert all(getattr(augment, n) is before[n] for n in pl.INNER_PARTS)
    assert loader.BatchLoader._pack is pack
    for w in workers:
        r = out[str(w)]
        assert r["batches"] == 6 and r["parts"]["_pack"]["calls"] == 6
        parts = r["parts"]
        assert parts["load_image"]["calls"] >= 24
        assert parts["random_affine"]["calls"] == 24
        # A paste fills its mask and warps its donor once each.
        assert parts["_warp"]["calls"] == 24 + parts["fill_poly"]["calls"]
        assert parts["mosaic4"]["calls"] + parts["letterbox_np"]["calls"] >= 24
        assert parts["polygons_to_overlap_mask"]["calls"] == 24
        assert parts["copy_paste"]["calls"] > 0
        top = sum(parts[p]["ms_a_batch"] for p in pl.TOP_PARTS + ("load_image",))
        assert parts["rest_of_pack"]["ms_a_batch"] == pytest.approx(
            parts["_pack"]["ms_a_batch"] - top)
        assert 0 < r["ms_a_batch_after_first"] and r["cpu_over_wall"] > 0


def test_timed_loader_packs_the_untimed_batches(ds):
    def batches():
        data = pl._Repeat(ds, 2)
        return list(loader.BatchLoader(data, batch_size=4, imgsz=64, aug=AUG,
                                       seed=0).epoch(workers=2))

    want = batches()
    with pl._timed_parts(pl._Clock()):
        got = batches()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
