"""The system under test, built for a cell and driven through its serving
loop. A traffic file names its loop (``"serving"``), and
``benchmark/loops/<serving>.py`` holds it: a subclass of ``Loop`` that
builds the port's processor and serves for a window. A new way of serving
is a new file there.

Every frame the loop answers is kept, in a compact form, for the check
that follows the window; every frame's (or step's) host times are kept for
the metrics. Frame i of a stream is stamped ``now_ms = i * frame_interval_ms``,
the camera's clock.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.harness.cell import load_module
from benchmark.harness.frames import stream_offsets


@dataclasses.dataclass
class Answer:
    """What the timed path returned for one frame of one stream."""
    stream: int
    seq: int                   # the frame's number in its stream
    pool_index: int
    now_ms: int
    occupancy: np.ndarray
    n_detections: int
    best_conf: float
    walkable: np.ndarray
    artificial: np.ndarray
    penalty: np.ndarray
    peaks: list
    paths: list                # [((L, 2) int32 cells, cost)]
    answer: str


def compact(result, stream: int, seq: int, pool_index: int, now_ms: int) -> Answer:
    return Answer(
        stream, seq, pool_index, now_ms, result.occupancy, int(result.n_detections),
        float(result.best_conf), result.walkable, result.artificial,
        np.asarray(result.penalty, np.float64),
        [(p.centre.x, p.centre.y, p.left.x, p.right.x, p.orientation) for p in result.peaks],
        [(np.array([(c.row, c.col) for c in p.cells], np.int32).reshape(-1, 2),
          float(p.total_cost)) for p in result.paths],
        result.final_answer)


def memory_form(previous: dict) -> dict:
    """An instruction memory (ms -> instructions) as plain tuples, floats
    to 9 decimals, so the program's and the reference's compare."""
    def form(i):
        return (i.direction, i.danger, i.instruction_type, i.start.x, i.start.y,
                i.end.x, i.end.y, round(i.distance, 9), round(i.angle_change, 9),
                round(i.length, 9))
    return {int(ts): [form(i) for i in ins] for ts, ins in previous.items()}


def build_segmenter(root, config: dict, traffic: dict, device):
    """The port's segmenter with the configuration's trained weights."""
    from vision_assist_tpu_torch.config import ModelConfig
    from vision_assist_tpu_torch.models.checkpoint import load_variables
    from vision_assist_tpu_torch.models.inference import Segmenter

    mcfg = ModelConfig(
        arch=config["arch"], num_classes=config["num_classes"], imgsz=config["imgsz"],
        conf_threshold=config["conf_threshold"], iou_threshold=config["iou_threshold"],
        max_detections=config["max_detections"], reg_max=config["reg_max"],
        num_mask_coeffs=config["num_mask_coeffs"], dtype=config["dtype"])
    return Segmenter(mcfg, variables=load_variables(root / config["weights"]),
                     example_hw=(traffic["frame_height"], traffic["frame_width"]),
                     grid_size=config["grid_size"], device=device)


def pipeline_config(config: dict, traffic: dict):
    from vision_assist_tpu_torch.config import GridConfig, PathFinderConfig, PipelineConfig

    return PipelineConfig(
        frame_height=traffic["frame_height"], frame_width=traffic["frame_width"],
        grid=GridConfig(grid_size=config["grid_size"]),
        pathfinder=PathFinderConfig(engine=traffic["engine"]),
        num_streams=traffic["streams"], transfer_format=config["transfer_format"])


class Loop:
    """One cell's serving loop over a frame pool. ``run(seconds)`` serves
    until the window has lasted ``seconds`` and returns its length;
    ``frame_ms``, ``frames_done`` and ``spans`` are the host times and the
    count of the frames (steps) of the last call. A subclass gives
    ``build`` (the port's processor), ``serve`` and ``carried``."""

    def __init__(self, root, config: dict, traffic: dict, pool: np.ndarray, device):
        self.traffic = traffic
        self.pool = pool
        self.interval = traffic["frame_interval_ms"]
        self.offsets = stream_offsets(traffic)
        self.answers: list[Answer] = []
        self.attempted = 0
        self.segmenter = build_segmenter(root, config, traffic, device)
        self.processor = self.build(pipeline_config(config, traffic), device)
        self.seq = 0            # the next frame (step) of every stream

    def build(self, cfg, device):
        raise NotImplementedError

    def serve(self, seconds: float) -> float:
        raise NotImplementedError

    def carried(self) -> list[tuple[int, dict]]:
        """(A* angle cache entries, instruction memory) of each stream, read
        from the attributes of the port's processor that hold them."""
        raise NotImplementedError

    def pool_index(self, stream: int, seq: int) -> int:
        return (self.offsets[stream] + seq) % len(self.pool)

    def run(self, seconds: float) -> float:
        """Serve for ``seconds``; returns the window's length in seconds."""
        self.frame_ms: list[float] = []          # a frame (sync) or a step (batched)
        self.frames_done = 0
        self.spans: dict[str, list[float]] = {"submit": [], "retire": []}
        return self.serve(seconds)

    def keep(self, result, stream: int, seq: int) -> None:
        """Keep what the timed path returned for frame ``seq`` of ``stream``."""
        if result is None:
            return
        self.answers.append(compact(result, stream, seq, self.pool_index(stream, seq),
                                    seq * self.interval))
        self.frames_done += 1

    def state(self) -> list[dict]:
        """Each stream's carried state after the last frame, in the form the
        check compares: through the processor's ``carried_state()`` where the
        port has one (a list of (cache entries, instruction memory) a
        stream), else through ``carried``."""
        p = self.processor
        carried = p.carried_state() if hasattr(p, "carried_state") else self.carried()
        return [{"cache_keys": int(keys), "memory": memory_form(memory)}
                for keys, memory in carried]

    def close(self) -> None:
        pass


def make_loop(root, config: dict, traffic: dict, pool: np.ndarray, device) -> Loop:
    """The loop of ``benchmark/loops/<traffic["serving"]>.py``, built for the cell."""
    module = load_module(root, "loops", traffic["serving"])
    return module.Loop(root, config, traffic, pool, device)
