"""The port's entry points take the JAX package's parameters in the JAX
order, with the same defaults, so a call written for one package means the
same in the other; the port may only add parameters at the end (such as
``device``). ``FrameResult`` and ``AugmentConfig`` have the JAX fields in
the JAX order.
"""

from __future__ import annotations

import dataclasses
import inspect

import pytest

jax = pytest.importorskip("jax")

from vision_assist_tpu.data import augment as jaug  # noqa: E402
from vision_assist_tpu.data import dataset as jds  # noqa: E402
from vision_assist_tpu.data import loader as jloader  # noqa: E402
from vision_assist_tpu.models import evaluate as jeval  # noqa: E402
from vision_assist_tpu.pipeline import frame_processor as jfp  # noqa: E402
from vision_assist_tpu.pipeline import multi_stream as jms  # noqa: E402
from vision_assist_tpu.pipeline import server as jserver  # noqa: E402
from vision_assist_tpu_torch.data import augment as taug  # noqa: E402
from vision_assist_tpu_torch.data import dataset as tds  # noqa: E402
from vision_assist_tpu_torch.data import loader as tloader  # noqa: E402
from vision_assist_tpu_torch.models import evaluate as teval  # noqa: E402
from vision_assist_tpu_torch.pipeline import frame_processor as tfp  # noqa: E402
from vision_assist_tpu_torch.pipeline import multi_stream as tms  # noqa: E402
from vision_assist_tpu_torch.pipeline import server as tserver  # noqa: E402

PAIRS = {
    "FrameProcessor.__init__": (jfp.FrameProcessor.__init__, tfp.FrameProcessor.__init__),
    "FrameProcessor.process_occupancy": (jfp.FrameProcessor.process_occupancy,
                                         tfp.FrameProcessor.process_occupancy),
    "FrameProcessor.retire_frame": (jfp.FrameProcessor.retire_frame,
                                    tfp.FrameProcessor.retire_frame),
    "FrameProcessor.submit_frame": (jfp.FrameProcessor.submit_frame,
                                    tfp.FrameProcessor.submit_frame),
    "FrameProcessor.__call__": (jfp.FrameProcessor.__call__, tfp.FrameProcessor.__call__),
    "MultiStreamProcessor.__init__": (jms.MultiStreamProcessor.__init__,
                                      tms.MultiStreamProcessor.__init__),
    "StreamingServer.__init__": (jserver.StreamingServer.__init__,
                                 tserver.StreamingServer.__init__),
    "BatchedStreamingServer.__init__": (jserver.BatchedStreamingServer.__init__,
                                        tserver.BatchedStreamingServer.__init__),
    "BatchLoader.__init__": (jloader.BatchLoader.__init__, tloader.BatchLoader.__init__),
    "SegDataset.__init__": (jds.SegDataset.__init__, tds.SegDataset.__init__),
    "evaluate": (jeval.evaluate, teval.evaluate),
    "random_affine": (jaug.random_affine, taug.random_affine),
    "copy_paste": (jaug.copy_paste, taug.copy_paste),
    "mosaic4": (jaug.mosaic4, taug.mosaic4),
    "flip_lr": (jaug.flip_lr, taug.flip_lr),
    "letterbox_np": (jaug.letterbox_np, taug.letterbox_np),
}
# Parameters the port may add after the JAX ones.
TRAILING_EXTRAS = {"device"}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_parameters_in_the_jax_order(name):
    want, got = (list(inspect.signature(f).parameters.values()) for f in PAIRS[name])
    assert [p.name for p in got[:len(want)]] == [p.name for p in want], name
    assert {p.name for p in got[len(want):]} <= TRAILING_EXTRAS, name
    for a, b in zip(got, want):
        assert a.kind == b.kind, (name, a.name)
        assert a.default == b.default, (name, a.name, a.default, b.default)


@pytest.mark.parametrize("pair", [(jfp.FrameResult, tfp.FrameResult),
                                  (jaug.AugmentConfig, taug.AugmentConfig)],
                         ids=["FrameResult", "AugmentConfig"])
def test_dataclass_fields_in_the_jax_order(pair):
    want, got = (dataclasses.fields(c) for c in pair)
    assert [(f.name, f.default) for f in got] == [(f.name, f.default) for f in want]


def test_debug_raises_until_the_visualiser_is_ported():
    with pytest.raises(NotImplementedError, match="visualiser"):
        tfp.FrameProcessor(None, None, True, device="cpu")
    # A third positional False is debug, as in JAX, not replay_rounding.
    fp = tfp.FrameProcessor(None, None, False, True, device="cpu")
    assert fp._replay_rounding is True
