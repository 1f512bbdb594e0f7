"""Deployed-model ("flagship") selection, read from and written to
``assets/weights/FLAGSHIP.json``.

The record names the checkpoint, its arch and its imgsz, with the promotion's
provenance. Absent the file, the defaults name the historical flagship
(yolov8n-seg @ imgsz 640, ``v8n_640_best.msgpack``).
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any

from vision_assist_tpu_torch.config import ModelConfig

REPO = pathlib.Path(__file__).resolve().parents[2]
FLAGSHIP_PATH = REPO / "assets" / "weights" / "FLAGSHIP.json"

_DEFAULT: dict[str, Any] = {
    "asset": "v8n_640_best.msgpack",
    "arch": "yolov8n-seg",
    "imgsz": 640,
}


def flagship() -> dict[str, Any]:
    """The deployed-model record (defaults merged under the file, if any)."""
    rec = dict(_DEFAULT)
    try:
        rec.update(json.loads(FLAGSHIP_PATH.read_text()))
    except (OSError, json.JSONDecodeError):
        pass
    return rec


def weights_path() -> pathlib.Path | None:
    """Absolute path of the flagship checkpoint, or None if not on disk."""
    p = REPO / "assets" / "weights" / flagship()["asset"]
    return p if p.exists() else None


def model_config(**overrides: Any) -> ModelConfig:
    """ModelConfig for the flagship arch/imgsz (kwargs override)."""
    rec = flagship()
    kw: dict[str, Any] = {"arch": rec["arch"], "imgsz": int(rec["imgsz"])}
    kw.update(overrides)
    return ModelConfig(**kw)


def load_flagship_variables():
    """Flagship weights as the Flax variables tree of numpy arrays, or None."""
    p = weights_path()
    if p is None:
        return None
    from vision_assist_tpu_torch.models.checkpoint import load_variables

    return load_variables(p)


def write_flagship(asset: str, arch: str, imgsz: int,
                   path: str | pathlib.Path = FLAGSHIP_PATH,
                   **provenance: Any) -> dict[str, Any]:
    """Publish a new deployed-model record at ``path``, through a temporary
    file and a rename, so a reader never sees a torn record."""
    rec: dict[str, Any] = {"asset": asset, "arch": arch, "imgsz": int(imgsz),
                           "switched_at": time.strftime(
                               "%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    rec.update(provenance)
    path = pathlib.Path(path)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(rec, indent=1))
    tmp.replace(path)
    return rec
