"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository's root."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def make_root(tmp_path, cells=(), traffic=None, limits=None):
    """A checkout of the benchmark in ``tmp_path``: BENCHMARK.json, the
    benchmark's data files and reference modules copied, the weights linked,
    plus ``cells``
    (manifest entries) with their ``traffic`` and ``limits`` files."""
    import json
    import shutil

    root = tmp_path / "checkout"
    (root / "benchmark").mkdir(parents=True)
    for sub in ("configs", "traffic", "limits", "metrics", "loops", "reference"):
        shutil.copytree(ROOT / "benchmark" / sub, root / "benchmark" / sub)
    (root / "assets").symlink_to(ROOT / "assets")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {c["file"] for c in manifest["configs"]}
    for path in sorted((ROOT / "benchmark" / "configs").glob("*.json")):
        file = f"benchmark/configs/{path.name}"
        if file not in listed:      # a configuration no cell of BENCHMARK.json uses now
            manifest["configs"].append({"name": json.loads(path.read_text())["name"],
                                        "source": "", "file": file, "reduced": [], "why": ""})
    manifest["workloads"] += list(cells)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    for name, data in (traffic or {}).items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(data))
    for name, data in (limits or {}).items():
        (root / "benchmark" / "limits" / f"{name}.json").write_text(json.dumps(data))
    return root


# A small traffic mix for runs on the CPU: four 1280x720 walkways from scenes
# seed 10, two of which yolov8n-seg@640 detects in (scenes 0 and 3, best
# scores 0.75, the others' below 0.35), so every stage has work on some
# frames; CPU_SEED rotates them.
CPU_SEED = 10


def cpu_traffic(serving: str, pool: int = 4, scenes_seed: int = CPU_SEED) -> dict:
    t = {"pool": pool, "scenes_seed": scenes_seed, "frame_height": 1280, "frame_width": 720,
         "frame_interval_ms": 33, "warmup": 1}
    if serving == "sync":
        t.update(streams=1, serving="sync", engine="exact")
    else:
        t.update(streams=2, serving="batched", depth=2, engine="exact_device")
    return t


def cpu_root(tmp_path, pool: int = 4, scenes_seed: int = CPU_SEED):
    import json

    limits = json.loads((ROOT / "benchmark" / "limits" / "v8n640.cam720.batch8.json")
                        .read_text())
    sync_limits = json.loads((ROOT / "benchmark" / "limits" / "v8n640.cam720.sync.json")
                             .read_text())
    cells = [{"name": "cpu.sync", "config": "yolov8n-seg-640", "traffic": "cpu.sync",
              "chips": 1, "why": "a CPU run of the harness"},
             {"name": "cpu.batch2", "config": "yolov8n-seg-640", "traffic": "cpu.batch2",
              "chips": 1, "why": "a CPU run of the harness"}]
    return make_root(tmp_path, cells,
                     {"cpu.sync": cpu_traffic("sync", pool, scenes_seed),
                      "cpu.batch2": cpu_traffic("batched", pool, scenes_seed)},
                     {"cpu.sync": sync_limits, "cpu.batch2": limits})
