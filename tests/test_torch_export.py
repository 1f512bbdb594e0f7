"""Export of the segmenter chain through ``torch.export``, at the size of the
JAX package's export test (imgsz 160, a 320x320 frame), on the CPU:

* the program saved by ``torch.export.save`` and read back by
  ``torch.export.load`` gives outputs bit-equal to the eager port chain, and
  calls the ConvBNAct epilogue operators ``vision_assist_tpu_torch::bn_act``
  and ``bn_act_into``;
* the eager chain equals JAX's ``Segmenter._frame_chain`` on the same
  weights (the flagship, float32) and frame: detections valid in the same
  slots, boxes and scores within atol 1e-3 + rtol 1e-3 (the model tests'
  tolerance), occupancy flags equal except where the winning mask's logit is
  within 1e-3 of the 0 threshold;
* ``python -m vision_assist_tpu_torch.export_model`` writes
  ``inference.pt2`` and a ``variables.msgpack`` that JAX's
  ``load_variables`` reads back equal.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.models.checkpoint import load_variables as jax_load_variables  # noqa: E402
from vision_assist_tpu.models.inference import Segmenter as JaxSegmenter  # noqa: E402
from vision_assist_tpu.ops.letterbox import sample_mask_logits_at_points  # noqa: E402
from vision_assist_tpu_torch import export_model  # noqa: E402
from vision_assist_tpu_torch.config import ModelConfig  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402
from vision_assist_tpu_torch.models import flagship  # noqa: E402
from vision_assist_tpu_torch.models.inference import Segmenter  # noqa: E402

torch.set_num_threads(2)

IMGSZ, HW = 160, (320, 320)


@pytest.fixture(scope="module")
def chain():
    """(port Segmenter, JAX Segmenter, frame): the flagship's weights in
    float32 at imgsz 160 on a seeded 320x320 walkway frame."""
    rec, variables = flagship.flagship(), flagship.load_flagship_variables()
    seg = Segmenter(ModelConfig(arch=rec["arch"], imgsz=IMGSZ, dtype="float32"),
                    variables=variables, example_hw=HW, device="cpu")
    jseg = JaxSegmenter(jconfig.ModelConfig(arch=rec["arch"], imgsz=IMGSZ,
                                            dtype="float32"),
                        variables=variables, example_hw=HW, grid_size=20)
    return seg, jseg, walkway_frames(1, *HW, seed=11)[0]


@pytest.fixture(scope="module")
def cli_export(tmp_path_factory):
    """`python -m vision_assist_tpu_torch.export_model` on the CPU with the
    flagship's weights at imgsz 160 for 320x320 frames: (its output
    directory, what it printed, a Segmenter in the CLI's configuration,
    bfloat16 as served)."""
    out = tmp_path_factory.mktemp("export")
    rec = flagship.flagship()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = export_model.main([
            "--weights", str(flagship.weights_path()), "--arch", rec["arch"],
            "--imgsz", str(IMGSZ), "--frame-hw", *map(str, HW), "--out", str(out),
            "--device", "cpu"])
    assert rc == 0
    seg = Segmenter(ModelConfig(arch=rec["arch"], imgsz=IMGSZ),
                    variables=flagship.load_flagship_variables(), example_hw=HW,
                    device="cpu")
    return out, buf.getvalue(), seg


@pytest.fixture(scope="module")
def exported(cli_export):
    """The saved program, read back by torch.export.load."""
    return torch.export.load(str(cli_export[0] / "inference.pt2")).module()


@pytest.mark.parametrize("seed", [None, 0])
def test_exported_program_bit_equal_to_the_eager_chain(chain, cli_export, exported,
                                                       seed):
    """On the walkway frame (the model finds it) and on a seeded noise frame."""
    seg = cli_export[2]
    frame = chain[2]
    if seed is not None:
        frame = np.random.default_rng(seed).integers(0, 255, (*HW, 3), np.uint8)
    x = torch.from_numpy(frame)
    got = exported(x)
    want = export_model.SegmenterChain(seg)(x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_exported_program_holds_the_epilogue_operator(exported):
    """Each ConvBNAct of the segmenter ends in the operator
    ``vision_assist_tpu_torch::bn_act``, or ``bn_act_into`` where it stores
    into a concatenation's slice, in the saved program (the chain's no-grad
    region is a submodule of it): 90 calls for the flagship yolo11n-seg, 21
    of them into a slice, no BatchNorm left."""
    calls = [str(n.target) for gm in exported.modules() if isinstance(gm, torch.fx.GraphModule)
             for n in gm.graph.nodes if n.op == "call_function"]
    into = calls.count("vision_assist_tpu_torch.bn_act_into.default")
    assert calls.count("vision_assist_tpu_torch.bn_act.default") + into == 90
    assert into == 21
    assert not any("batch_norm" in c for c in calls)


def test_eager_chain_matches_jax(chain):
    seg, jseg, frame = chain
    occ, boxes, scores, valid = (t.numpy() for t in
                                 export_model.SegmenterChain(seg)(torch.from_numpy(frame)))
    res = jseg._frame_chain(jseg.variables, jnp.asarray(frame))
    assert valid.any()
    np.testing.assert_array_equal(valid, np.asarray(res.detections.valid))
    np.testing.assert_allclose(boxes, np.asarray(res.detections.boxes), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(scores, np.asarray(res.detections.scores), atol=1e-3,
                               rtol=1e-3)
    flips = occ != np.asarray(res.occupancy)
    if flips.any():
        logits = sample_mask_logits_at_points(res.mask_logits, jseg._centres,
                                              dst=IMGSZ, threshold=False)
        won = np.asarray(logits[max(int(res.winner), 0)]).reshape(occ.shape)
        assert np.abs(won[flips]).max() < 1e-3, int(flips.sum())
    assert occ.sum() > 0


def test_export_model_cli(cli_export):
    """The command line writes both files; the weights read back by JAX
    equal those it was given."""
    out, printed, _ = cli_export
    assert "exported the segmenter chain" in printed
    assert (out / "inference.pt2").stat().st_size > 1000
    got = jax_load_variables(out / "variables.msgpack")
    want = jax_load_variables(flagship.weights_path())
    flat_got = jax.tree_util.tree_flatten_with_path(got)
    flat_want = jax.tree_util.tree_flatten_with_path(want)
    assert flat_got[1] == flat_want[1]
    for (path, a), (_, b) in zip(flat_got[0], flat_want[0]):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_export_model_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model.main(["--weights", str(flagship.weights_path()),
                           "--out", str(tmp_path)])
