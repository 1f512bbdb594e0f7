"""Typed configuration for the vision-assist TPU framework.

Every magic number that shapes observable behaviour in the reference is hoisted
here (reference: config.py:1-22 plus inlined constants catalogued in SURVEY.md §5
"Config / flag system"). The pipeline reads *only* from a PipelineConfig instance,
so behaviour variants (live vs. replay) are config changes, not code forks.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


# --- colour tables (BGR, reference config.py:4-22) -------------------------------

PENALTY_COLOUR_GRADIENT: dict[float, tuple[int, int, int]] = {
    1.0000: (0, 0, 255),
    0.9166: (0, 60, 255),
    0.8333: (0, 88, 255),
    0.7500: (0, 109, 255),
    0.6666: (0, 128, 255),
    0.5833: (8, 145, 255),
    0.5000: (0, 163, 249),
    0.4166: (0, 183, 232),
    0.3333: (0, 202, 208),
    0.1666: (0, 221, 176),
    0.0833: (0, 239, 129),
    0.0000: (0, 255, 15),
}

CLOSE_GRID_COLOUR = (255, 187, 111)
MID_GRID_COLOUR = (255, 53, 0)
FAR_GRID_COLOUR = (255, 0, 97)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Cell-lattice geometry. Reference: config.py:1 (grid_size = 20)."""

    grid_size: int = 20

    # Artificial always-walkable cells injected at the user's feet so a path can
    # always start there. Reference: FrameProcessor.py:60-65 (17 columns spanning
    # frame-centre +/- 8 cells) and :126 (rows start at 0.875*H, live pipeline) vs.
    # run_on_main.py:104 (0.8375*H in the replay tool).
    artificial_half_span_cells: int = 8
    artificial_row_start_frac: float = 0.875


@dataclasses.dataclass(frozen=True)
class PenaltyConfig:
    """Distance-from-edge penalty field. Reference: PenaltyCalculator.py:57-142."""

    # Cells with a row- or column-penalty above this are saturated to 1.
    saturation_threshold: float = 0.99
    # Dominance weighting: 0.5 +/- dominance_gain * |r-c|/(r+c).
    dominance_gain: float = 0.25


@dataclasses.dataclass(frozen=True)
class PeakConfig:
    """Protrusion/peak detection. Reference: ProtrusionDetector.py:59-158."""

    # Split top-row pixel runs on gaps wider than grid_size // peak_gap_divisor.
    # Reference: ProtrusionDetector.py:92 (gap > grid_size // 4).
    peak_gap_divisor: int = 4
    # Vertical slice below the peak is +/- slice half width (= grid_size).
    # Reference: ProtrusionDetector.py:102.
    # Upward test: height > width * 0.5 and slice_count > height * 0.5
    # (ProtrusionDetector.py:118-119).
    upward_height_ratio: float = 0.5
    upward_fill_ratio: float = 0.5
    # Static padding for the fixed-shape TPU kernel.
    max_peaks: int = 8


@dataclasses.dataclass(frozen=True)
class PathFinderConfig:
    """Curvature-penalised search. Reference: PathFinder.py:119-186."""

    # Sliding window of points for angle analysis (PathFinder.py:165: 7 points).
    angle_window: int = 7
    # No angle penalty at or below this many degrees (PathFinder.py:168).
    angle_grace_deg: float = 30.0
    # Penalty = (angle/90)^exponent above the grace angle (PathFinder.py:168).
    angle_exponent: float = 1.5
    angle_denominator: float = 90.0
    # Edge multiplier = 1 + penalty_weight*penalty + angle_weight*angle_penalty
    # (PathFinder.py:171).
    penalty_weight: float = 0.5
    angle_weight: float = 1.5

    # The reference caches angles across frames and stores radians while fresh
    # computations return degrees (PathFinder.py:97-99) — effectively silencing
    # the angle penalty on cache hits. Default True: the exact engine replicates
    # the reference bit-for-bit (parity is the north star). Set False for the
    # "fixed" deterministic semantics (degrees always) — documented deviation.
    replicate_radians_cache_bug: bool = True

    # Turn-cost weight for the WAVEFRONT engine. The reference's selected
    # paths pay zero angle penalty (the window term only steers exploration;
    # see PARITY.md) — their costs are exactly dist*(1+0.5*penalty). A tiny
    # epsilon turn cost reproduces the smoothness tie-breaking without ever
    # outweighing real cost differences; 1e-4 maximises fixture agreement
    # (12/13 end-to-end answers) while staying ~33 f32 ulps above rounding.
    wavefront_turn_weight: float = 1e-4
    # Static padding for the fixed-shape TPU pathfinder.
    max_path_len: int = 512
    # Run the wavefront relaxation as the fused Pallas kernel
    # (ops/pallas_wavefront.py) instead of the XLA while_loop. The kernel
    # keeps the whole sweep loop in VMEM — wins when per-iteration dispatch
    # dominates. Off by default pending real-chip latency validation.
    use_pallas_relax: bool = False
    # Fast-sweeping relaxation (planning/wavefront.py::relax_sweep):
    # directional min-plus scans relax whole corridors per pass, converging
    # in O(turns) passes instead of O(path length) per-cell sweeps (4-8x
    # fewer device-loop iterations on the fixtures; same fixed point,
    # identical backtraced paths). Ignored when use_pallas_relax is set.
    use_sweep_relax: bool = True
    # Which engine the pipeline uses.
    #  "exact"        — host A* twin (C++ native when a compiler exists,
    #                   numpy otherwise), bit-matching the reference.
    #  "exact_device" — the SAME exact algorithm inside one lax.while_loop on
    #                   the chip (planning/device_astar.py): sequential pops,
    #                   stale priorities, radians-cache bug, carried
    #                   cross-frame angle cache — path-identical to the host
    #                   twin on all 13 fixtures incl. insane_case.
    #  "wavefront"    — batched Markovian min-plus relaxation, the fastest
    #                   on-chip option (vmappable); answers agree on 12/13
    #                   fixtures (insane_case picks a different corridor).
    # Default "exact" for both the single-stream pipeline and the
    # multi-stream server (one engine per stream, threaded): on the 36x64
    # lattice the native engine plans in 0.3-1.6 ms/frame, so serving gets
    # bit-parity with the reference at no latency cost, and the device plan
    # step skips the path search entirely.
    engine: Literal["exact", "exact_device", "wavefront"] = "exact"


@dataclasses.dataclass(frozen=True)
class PathDedupConfig:
    """Jaccard path de-duplication. Reference: FrameProcessor.py:209-271."""

    similarity_threshold: float = 0.90


@dataclasses.dataclass(frozen=True)
class SectionConfig:
    """Path sectioning / corner detection. Reference: models.py:160-364."""

    # A straight section needs at least this many aligned cells (models.py:190).
    min_straight_cells: int = 5
    # Between-sections shorter than this merge into the previous section
    # (models.py:209).
    merge_below_cells: int = 4
    # Corner sharpness threshold in degrees (models.py:352).
    sharp_angle_deg: float = 30.0


@dataclasses.dataclass(frozen=True)
class AnalyserConfig:
    """Instruction synthesis. Reference: PathAnalyser.py (thresholds at
    :53-65, :95, :106-127, :189, :213, :221, :242-283)."""

    min_path_length_frac: float = 0.3          # PathAnalyser.py:53
    path_danger_high_deg: float = 45.0         # :57
    path_danger_medium_deg: float = 25.0       # :59
    bearing_below_deg: float = 20.0            # :65
    curve_below_deg: float = 35.0              # :65
    corner_min_y_frac: float = 0.5             # :95
    corner_danger_immediate: float = 0.75      # :120
    corner_danger_high: float = 0.65           # :122
    corner_danger_medium: float = 0.45         # :124
    pair_max_time_ms: int = 1500               # :189
    pair_max_move_frac: float = 0.2            # :213, :221
    bearing_escalate_high_deg: float = 12.5    # :245
    bearing_escalate_medium_deg: float = 7.5   # :249
    bearing_escalate_low_deg: float = 3.75     # :253
    turn_escalate_high_deg: float = 15.0       # :261
    turn_escalate_medium_deg: float = 10.0     # :265
    turn_escalate_low_deg: float = 7.5         # :269
    drop_above_frac: float = 0.33              # :281
    memory_window_ms: int = 5000               # :381


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Segmentation model. Reference: main.py:43 (YOLO(...)), model/train.py:12-13.

    ``arch`` decides what the model returns and how the lattice is read
    from it: a YOLO-seg (``yolo*``) returns detections and masks (the
    reference's); a SegFormer (``segformer-*``) returns per-pixel class
    logits, a cell occupied where its winning class is one of
    ``walkable_classes``. The thresholds, ``reg_max`` and
    ``num_mask_coeffs`` are a YOLO-seg's alone, ``walkable_classes`` a
    SegFormer's alone."""

    arch: Literal["yolov8n-seg", "yolo11n-seg", "yolo11n-seg-legacy",
                  "yolo12n-seg", "yolo12s-seg", "yolo12m-seg", "yolo12l-seg",
                  "yolo12x-seg", "yolov9e-seg", "segformer-b5"] = "yolov8n-seg"
    num_classes: int = 1                      # model/data.yaml:6
    imgsz: int = 640
    conf_threshold: float = 0.5               # FrameProcessor.py:322
    iou_threshold: float = 0.7                # ultralytics default NMS IoU
    max_detections: int = 32                  # padded static NMS output
    reg_max: int = 16                         # DFL bins
    num_mask_coeffs: int = 32
    dtype: str = "bfloat16"
    walkable_classes: tuple[int, ...] = (1,)   # Cityscapes' train id 1, sidewalk

    def __post_init__(self):
        object.__setattr__(self, "walkable_classes", tuple(self.walkable_classes))


@dataclasses.dataclass(frozen=True)
class BlurConfig:
    """Blur gate. Reference: FrameProcessor.py:44-48 (threshold 100, disabled
    in the live path at :314-319)."""

    laplacian_var_threshold: float = 100.0
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    frame_height: int = 1280
    frame_width: int = 720
    grid: GridConfig = GridConfig()
    penalty: PenaltyConfig = PenaltyConfig()
    peaks: PeakConfig = PeakConfig()
    pathfinder: PathFinderConfig = PathFinderConfig()
    dedup: PathDedupConfig = PathDedupConfig()
    sections: SectionConfig = SectionConfig()
    analyser: AnalyserConfig = AnalyserConfig()
    model: ModelConfig = ModelConfig()
    blur: BlurConfig = BlurConfig()
    # Process every Nth camera frame (reference main.py:70).
    process_every_n_frames: int = 15
    # Number of concurrent camera streams batched per jitted step.
    num_streams: int = 1
    # Host->device frame transfer format. "bgr" ships the raw (H, W, 3)
    # uint8 frame; "i420" ships the camera-native YUV 4:2:0 plane (2.13x
    # fewer bytes, converted back to BGR on-device — ops/yuv.py). The
    # serving paths (bench, main.py video) opt into "i420"; "bgr" stays the
    # default so pinned goldens are bit-stable.
    transfer_format: str = "bgr"

    @property
    def lattice_rows(self) -> int:
        return self.frame_height // self.grid.grid_size

    @property
    def lattice_cols(self) -> int:
        return self.frame_width // self.grid.grid_size

    def replace(self, **kwargs) -> "PipelineConfig":
        return dataclasses.replace(self, **kwargs)


def replay_config(rows: int = 64, cols: int = 36) -> PipelineConfig:
    """Config matching the reference's saved-grid replay harness
    (run_on_main.py:45-145): full-frame lattice, artificial rows from 0.8375*H."""
    return PipelineConfig(
        frame_height=rows * 20,
        frame_width=cols * 20,
        grid=GridConfig(artificial_row_start_frac=0.8375),
    )
