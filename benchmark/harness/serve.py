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


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration: each of its keys that
    names a field of ``ModelConfig``, the field's default for the others."""
    from vision_assist_tpu_torch.config import ModelConfig

    return ModelConfig(**{f.name: config[f.name] for f in dataclasses.fields(ModelConfig)
                          if f.name in config})


def build_segmenter(config: dict, traffic: dict, variables: dict, device):
    """The port's segmenter with the configuration's weights, the Flax tree
    ``variables`` (``harness.weights.flax_tree``)."""
    from vision_assist_tpu_torch.models.inference import Segmenter

    return Segmenter(model_config(config), variables=variables,
                     example_hw=(traffic["frame_height"], traffic["frame_width"]),
                     grid_size=config["grid_size"], device=device)


def served_outputs(loop):
    """The served module's head outputs for each step the loop serves: for
    each of ``loop.step_batches()``, (step, its pool indices, the outputs),
    the step's frames taken through the timed path's own steps to the
    model's input (the host I420 packer, the device unpack, the letterbox),
    a whole step in one batch, as the window served it. A generator: each
    batch's outputs are made as they are asked for."""
    import torch
    from vision_assist_tpu_torch.ops.letterbox import letterbox
    from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host, i420_to_bgr

    segmenter, h, w = loop.segmenter, loop.traffic["frame_height"], loop.traffic["frame_width"]
    for step, indices in enumerate(loop.step_batches()):
        frames = loop.pool[indices]
        with torch.no_grad():
            if loop.config["transfer_format"] == "i420":
                planes = np.stack([bgr_to_i420_host(f) for f in frames])
                bgr = i420_to_bgr(torch.from_numpy(planes).to(segmenter.device), h, w)
            else:
                bgr = torch.from_numpy(frames).to(segmenter.device)
            img = letterbox(bgr, dst=loop.config["imgsz"])
            outs = segmenter.model(img.permute(0, 3, 1, 2))
        yield step, indices, outs


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
    ``build`` (the port's processor) and ``serve``."""

    def __init__(self, config: dict, traffic: dict, pool: np.ndarray, variables: dict,
                 device):
        self.config = config
        self.traffic = traffic
        self.pool = pool
        self.interval = traffic["frame_interval_ms"]
        self.offsets = stream_offsets(traffic)
        self.answers: list[Answer] = []
        self.attempted = 0
        self.segmenter = build_segmenter(config, traffic, variables, device)
        self.processor = self.build(pipeline_config(config, traffic), device)
        self.seq = 0            # the next frame (step) of every stream

    def build(self, cfg, device):
        raise NotImplementedError

    def serve(self, seconds: float) -> float:
        raise NotImplementedError

    def pool_index(self, stream: int, seq: int) -> int:
        return (self.offsets[stream] + seq) % len(self.pool)

    def step_batches(self) -> list[list[int]]:
        """The pool indices of each step's frames, one list a step, for the
        first ``len(pool)`` steps: step ``k + len(pool)`` serves step k's."""
        streams = self.traffic["streams"]
        return [[self.pool_index(s, k) for s in range(streams)] for k in range(len(self.pool))]

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
        check compares, read through the processor's ``carried_state()`` (a
        list of (cache entries, instruction memory) a stream)."""
        return [{"cache_keys": int(keys), "memory": memory_form(memory)}
                for keys, memory in self.processor.carried_state()]

    def close(self) -> None:
        pass


def make_loop(root, config: dict, traffic: dict, pool: np.ndarray, variables: dict,
              device) -> Loop:
    """The loop of ``benchmark/loops/<traffic["serving"]>.py``, built for the
    cell with the weights ``variables``."""
    module = load_module(root, "loops", traffic["serving"])
    return module.Loop(config, traffic, pool, variables, device)
