"""Port parity for the checkpoint soup (``vision_assist_tpu_torch/soup_sweep.py``
against ``scripts/soup_sweep.py``).

``blend`` of ``v8n_640_best`` and ``v8n_640_r2_best`` at alphas 0.3, 0.5 and
0.7 is bit-equal to JAX's ``blend``, on the Flax trees ``load_variables``
returns and on the model's state dicts (the sum from 0 in the trees' order,
each product in float32). A soup evaluated on seeded walkways equals JAX's
``evaluate`` within the evaluate test's tolerance (atol 1e-6,
tests/test_torch_dataset.py). The sweep writes into ``--out`` only: never
``assets/weights/`` or ``TRAINING_RESULTS.json``, as the JAX script does (a
recorded departure).
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.models.checkpoint import load_variables as jax_load  # noqa: E402
from vision_assist_tpu_torch import soup_sweep  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import WalkwaySet, write_split  # noqa: E402
from vision_assist_tpu_torch.models.checkpoint import load_variables  # noqa: E402
from vision_assist_tpu_torch.models.yolo import YoloSeg, convert_flax_variables  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
BASE = REPO / "assets" / "weights" / "v8n_640_best.msgpack"
R2 = REPO / "assets" / "weights" / "v8n_640_r2_best.msgpack"


@pytest.fixture(scope="module")
def jax_blend():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from soup_sweep import blend
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return blend


@pytest.fixture(scope="module")
def walkways(tmp_path_factory):
    root = tmp_path_factory.mktemp("soup_data")
    write_split(WalkwaySet(4, 96, 128, seed=5), root, "valid")
    return root


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.7])
def test_blend_bit_equal_to_jax(jax_blend, alpha):
    want = jax_blend([jax_load(BASE), jax_load(R2)], [alpha, 1.0 - alpha])
    got = soup_sweep.blend([load_variables(BASE), load_variables(R2)],
                           [alpha, 1.0 - alpha])
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(list(_leaves(want))) > 100
    for (path, g), (wpath, w) in pairs:
        assert path == wpath and g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg="/".join(path))
    # the same soup from the model's state dicts, leaf for leaf
    model = YoloSeg("yolov8n-seg", dtype=torch.float32)
    sds = [convert_flax_variables(load_variables(p), model) for p in (BASE, R2)]
    soup = soup_sweep.blend(sds, [alpha, 1.0 - alpha])
    ref = convert_flax_variables(want, model)
    assert soup.keys() == ref.keys()
    for k in ref:
        assert torch.equal(soup[k], ref[k]), k


def test_blend_refuses_weights_and_trees_that_do_not_fit():
    tree = {"a": np.ones(3, np.float32)}
    with pytest.raises(ValueError, match="sum to 1"):
        soup_sweep.blend([tree, tree], [0.5, 0.6])
    with pytest.raises(ValueError, match="structure"):
        soup_sweep.blend([tree, {"b": np.ones(3, np.float32)}], [0.5, 0.5])
    ints = [{"n": torch.tensor(3)}, {"n": torch.tensor(4)}]
    with pytest.raises(ValueError, match="integer"):
        soup_sweep.blend(ints, [0.5, 0.5])


def test_soup_evaluates_like_jax(jax_blend, walkways):
    """The 0.5 soup through JAX's evaluate and the port's, float32, imgsz 128."""
    from vision_assist_tpu.models.evaluate import evaluate as jax_evaluate
    from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg
    from vision_assist_tpu_torch.models.evaluate import evaluate

    jsoup = jax_blend([jax_load(BASE), jax_load(R2)], [0.5, 0.5])
    want = jax_evaluate(JaxYoloSeg(arch="yolov8n-seg", num_classes=1, dtype=jnp.float32),
                        jsoup, str(walkways), "valid", imgsz=128, batch_size=2)
    soup = soup_sweep.blend([load_variables(BASE), load_variables(R2)], [0.5, 0.5])
    got = evaluate(YoloSeg("yolov8n-seg", dtype=torch.float32), soup, walkways, "valid",
                   imgsz=128, batch_size=2, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def _snapshot():
    weights = REPO / "assets" / "weights"
    return ({p.name: p.stat().st_mtime_ns for p in weights.iterdir()},
            (REPO / "TRAINING_RESULTS.json").read_bytes())


@pytest.mark.parametrize("maps,promoted", [((0.1, 0.3, 0.2), True),
                                           ((0.5, 0.5, 0.4), False)])
def test_sweep_writes_out_only(walkways, tmp_path, monkeypatch, maps, promoted, capsys):
    """The sweep over one candidate and one alpha (the base, the blend and
    the candidate alone, each through ``evaluate`` at imgsz 640 on the
    ``valid`` split of ``--data``; the mAPs scripted so that the blend gains
    strictly, or ties the base): soup_sweep.json always, best.msgpack only
    on a strict gain over the base, and nothing under assets/weights or in
    TRAINING_RESULTS.json."""
    calls = []

    def scripted(model, variables, root, split, imgsz, batch_size, verbose, device):
        calls.append((variables, root, split, imgsz, batch_size, device))
        return {"map50_mask": maps[len(calls) - 1]}

    monkeypatch.setattr(soup_sweep, "evaluate", scripted)
    before = _snapshot()
    out = tmp_path / "soup"
    doc = soup_sweep.run_sweep([R2], walkways, out, alphas=[0.5], eval_batch=2,
                               device="cpu")
    assert [c[1:] for c in calls] == [(walkways, "valid", 640, 2, "cpu")] * 3
    base, r2 = load_variables(BASE), load_variables(R2)
    for got, want in zip([c[0] for c in calls],
                         [base, soup_sweep.blend([base, r2], [0.5, 0.5]), r2]):
        for (_, g), (_, w) in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(g, w)
    assert [r["blend"] for r in doc["rows"]] == [f"0.50*base + 0.50*{R2}",
                                                 f"candidate {R2} alone"]
    assert doc["baseline_map50_mask"] == maps[0]
    assert doc["promoted"] is promoted
    assert sorted(p.name for p in out.iterdir()) == (
        ["best.msgpack", "soup_sweep.json"] if promoted else ["soup_sweep.json"])
    if promoted:
        assert doc["best"] == f"0.50*base + 0.50*{R2}"
        best = load_variables(out / "best.msgpack")
        for (_, g), (_, w) in zip(_leaves(best), _leaves(calls[1][0])):
            np.testing.assert_array_equal(g, w)
    assert _snapshot() == before
    capsys.readouterr()


def test_sweep_command_line_requires_data_and_out():
    ap = soup_sweep.build_parser()
    for argv in (["c.msgpack", "--out", "o"], ["c.msgpack", "--data", "d"]):
        with pytest.raises(SystemExit):
            ap.parse_args(argv)
    args = ap.parse_args(["c.msgpack", "--data", "d", "--out", "o"])
    assert sorted(vars(args)) == ["alphas", "candidates", "data", "device", "eval_batch",
                                  "out"]
    assert (args.alphas, args.eval_batch, args.device) == ("0.3,0.5,0.7", 16, "cuda")
