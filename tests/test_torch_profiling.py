"""The port's timing tools (``utils/profiling.py``) against the JAX
package's:

* ``StageTimer``: the same samples give byte-equal ``write`` and
  ``write_samples`` files and an equal ``summary``;
* ``device_trace`` writes a Chrome trace, and on a missing card raises.
"""

from __future__ import annotations

import json

import pytest
import torch

pytest.importorskip("jax")

from vision_assist_tpu.utils.profiling import StageTimer as JaxStageTimer  # noqa: E402
from vision_assist_tpu_torch.utils.profiling import StageTimer, device_trace  # noqa: E402

torch.set_num_threads(2)


def _timers(cls):
    t = cls()
    for i in range(5):
        t.add_sample("segment", 0.01 * (i + 1) / 3)
        t.add_sample("plan", 1e-3 * (7 - i))
        t.add_sample("plan", 2.5e-4)
        if i == 3:
            t.add_sample("host", 0.125)
        t.end_frame()
    return t


def test_stage_timer_files_are_byte_equal_to_jax(tmp_path):
    got, want = _timers(StageTimer), _timers(JaxStageTimer)
    assert got.summary() == want.summary()
    got.write(tmp_path / "port.txt")
    want.write(tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    got.write_samples(tmp_path / "port.json")
    want.write_samples(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_stage_timer_drops_an_outlier_frame_as_jax_does():
    for cls in (StageTimer, JaxStageTimer):
        t = cls(outlier_threshold_s=0.0)
        with t.stage("a"):
            pass
        t.end_frame()
        t2 = cls(outlier_threshold_s=10.0)
        with t2.stage("a"):
            pass
        t2.end_frame()
        assert (dict(t.samples), len(t2.samples["a"])) == ({}, 1), cls


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace", device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with device_trace(tmp_path):
            pass
