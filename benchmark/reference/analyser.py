"""Temporal instruction synthesis — exact twin of the reference PathAnalyser.

Reproduces PathAnalyser.py:15-390 with the singleton's hidden state made
explicit: the 5-second instruction memory is an ordinary attribute keyed by a
caller-supplied millisecond timestamp, so a batched/jitted pipeline can carry
it per stream and tests can drive time deterministically (the reference reads
the wall clock at PathAnalyser.py:335).

Behavioural quirks preserved on purpose (SURVEY.md §7 hard part 4):

* instruction type uses the SIGNED path angle, so sharp left bends classify as
  "bearing" (PathAnalyser.py:65);
* filtering iterates a list while removing from it, which skips the element
  after each removal (PathAnalyser.py:276-283);
* the filtered list is the *insertion-ordered* one — the sorted copy is only
  stored into memory (PathAnalyser.py:359-375), so the "primary" instruction in
  determine_final_instruction is first-inserted, not highest-priority;
* escalation can fire repeatedly for one instruction when several previous
  instructions pair with it (PathAnalyser.py:234-273).
"""

from __future__ import annotations

import math

from benchmark.reference.config import AnalyserConfig
from benchmark.reference.sections import AnalysedPath
from benchmark.reference.types import FinalAnswer, Instruction

_DANGER_ORDER = {"immediate": 0, "high": 1, "medium": 2, "low": 3}
_TYPE_ORDER = {"turn": 0, "curve": 0, "bearing": 1}


class InstructionEngine:
    def __init__(self, cfg: AnalyserConfig | None = None, verbose: bool = False):
        self.cfg = cfg or AnalyserConfig()
        self.verbose = verbose
        # ms timestamp -> instructions issued that frame (sorted, unfiltered),
        # pruned to the trailing memory window (PathAnalyser.py:375-382).
        self.previous_instructions: dict[int, list[Instruction]] = {}

    # -- per-path analysis (PathAnalyser.py:35-77) ---------------------------------

    def _analyse_path(self, path: AnalysedPath, frame_height: int) -> Instruction | None:
        angle = path.angle
        length = path.length
        if length < frame_height * self.cfg.min_path_length_frac:
            return None

        if abs(angle) > self.cfg.path_danger_high_deg:
            danger = "high"
        elif abs(angle) > self.cfg.path_danger_medium_deg:
            danger = "medium"
        else:
            danger = "low"

        # NOTE: signed comparison, per the reference (PathAnalyser.py:65).
        instruction_type = ("bearing" if angle < self.cfg.bearing_below_deg
                            else "curve" if angle < self.cfg.curve_below_deg
                            else "turn")
        direction = ("straight" if path.start.x == path.end.x
                     else "left" if path.start.x > path.end.x else "right")

        return Instruction(
            direction=direction, danger=danger,
            start=path.start, end=path.end,
            distance=length, angle_change=angle, length=length,
            instruction_type=instruction_type,
        )

    # -- per-corner analysis (PathAnalyser.py:79-143) -----------------------------

    def _analyse_corners(self, path: AnalysedPath, frame_height: int) -> list[Instruction]:
        out: list[Instruction] = []
        for corner in path.corners:
            distance = corner.start.y  # higher y == closer to the user
            if distance < frame_height * self.cfg.corner_min_y_frac:
                continue

            height_mult = math.exp((math.log(2) / frame_height) * distance) - 1
            angle_mult = math.exp((math.log(2) / 90) * abs(corner.angle_change)) - 1
            danger_value = height_mult * 0.7 + angle_mult * 0.3

            if danger_value > self.cfg.corner_danger_immediate:
                danger = "immediate"
            elif danger_value > self.cfg.corner_danger_high:
                danger = "high"
            elif danger_value > self.cfg.corner_danger_medium:
                danger = "medium"
            else:
                danger = "low"

            out.append(Instruction(
                direction=corner.direction, danger=danger,
                start=corner.start, end=corner.end,
                distance=distance, angle_change=corner.angle_change,
                length=corner.length,
                instruction_type="turn" if corner.sharpness == "sharp" else "curve",
            ))
        return out

    # -- temporal enrichment (PathAnalyser.py:158-284) -----------------------------

    def _enrich_with_memory(
        self,
        current: list[Instruction],
        now_ms: int,
        frame_height: int,
        frame_width: int,
    ) -> list[Instruction]:
        cfg = self.cfg
        if self.previous_instructions:
            pairs = []
            for prev_ts, prev_list in self.previous_instructions.items():
                for prev in prev_list:
                    for cur in current:
                        if (prev.instruction_type == "bearing"
                                and cur.instruction_type != "bearing"):
                            continue
                        if prev.distance > cur.distance:
                            continue
                        if prev.direction != cur.direction:
                            continue

                        dt = now_ms - prev_ts
                        y_diff = abs(prev.start.y - cur.start.y)
                        y_mult = prev.start.y / frame_height
                        if not (dt < cfg.pair_max_time_ms
                                and y_diff * y_mult
                                < frame_height * cfg.pair_max_move_frac):
                            continue
                        x_diff = abs(prev.start.x - cur.start.x)
                        x_mult = prev.start.y / frame_height
                        if not (dt < cfg.pair_max_time_ms
                                and x_diff * x_mult
                                < frame_width * cfg.pair_max_move_frac):
                            continue
                        # Only pair when danger has not decreased
                        # (PathAnalyser.py:227).
                        if _DANGER_ORDER[prev.danger] - _DANGER_ORDER[cur.danger] > 0:
                            continue
                        pairs.append((prev, cur))

            for prev, cur in pairs:
                direction_change = abs(prev.angle_change - cur.angle_change)
                if cur.instruction_type == "bearing":
                    if cur.danger == "high" and direction_change > cfg.bearing_escalate_high_deg:
                        cur.danger = "immediate"
                    elif cur.danger == "medium" and direction_change > cfg.bearing_escalate_medium_deg:
                        cur.danger = "high"
                    elif cur.danger == "low" and direction_change > cfg.bearing_escalate_low_deg:
                        cur.danger = "medium"
                else:
                    if cur.danger == "high" and direction_change > cfg.turn_escalate_high_deg:
                        cur.danger = "immediate"
                    elif cur.danger == "medium" and direction_change > cfg.turn_escalate_medium_deg:
                        cur.danger = "high"
                    elif cur.danger == "low" and direction_change > cfg.turn_escalate_low_deg:
                        cur.danger = "medium"

            # Mutation-while-iterating drop pass, replicated exactly
            # (PathAnalyser.py:276-283): removing an element skips the next one.
            for instruction in current:
                if instruction.instruction_type != "bearing":
                    if instruction.danger == "low":
                        current.remove(instruction)
                    elif instruction.distance < frame_height * cfg.drop_above_frac:
                        current.remove(instruction)

        return current

    # -- final collapse (PathAnalyser.py:286-313) ----------------------------------

    @staticmethod
    def determine_final_instruction(instructions: list[Instruction]) -> FinalAnswer:
        if not instructions:
            return FinalAnswer.CONTINUE_FORWARD

        immediate = [i for i in instructions if i.danger == "immediate"]
        if immediate:
            return (FinalAnswer.MOVE_LEFT if immediate[0].direction == "left"
                    else FinalAnswer.MOVE_RIGHT)

        if len(instructions) == 1 and instructions[0].instruction_type == "bearing":
            return FinalAnswer.CONTINUE_FORWARD

        primary = instructions[0]
        if primary.direction == "left":
            return FinalAnswer.MOVE_LEFT
        if primary.direction == "right":
            return FinalAnswer.MOVE_RIGHT
        return FinalAnswer.CONTINUE_FORWARD

    # -- frame entry point (PathAnalyser.py:316-386) -------------------------------

    def __call__(self, frame_height: int, frame_width: int,
                 paths: list[AnalysedPath], now_ms: int) -> str:
        instructions: list[Instruction] = []
        for path in paths:
            pi = self._analyse_path(path, frame_height)
            if pi:
                instructions.append(pi)
            if path.corners:
                instructions.extend(self._analyse_corners(path, frame_height))

        def sort_key(ins: Instruction):
            return (_TYPE_ORDER[ins.instruction_type], _DANGER_ORDER[ins.danger])

        # The sorted copy goes into memory; filtering and the final answer use
        # the insertion-ordered list (PathAnalyser.py:359-363, quirk preserved).
        stored = sorted(instructions, key=sort_key)
        filtered = self._enrich_with_memory(instructions, now_ms,
                                            frame_height, frame_width)

        # Same-millisecond frames overwrite each other's memory entry — a
        # faithful replication of the reference's dict-keyed-by-timestamp
        # memory (PathAnalyser.py:375, processing_time = int(time.time() *
        # 1000)); at TPU frame rates callers should pass distinct now_ms
        # (the serving paths do) if per-frame memory matters.
        self.previous_instructions[now_ms] = stored
        self.previous_instructions = {
            ts: ins for ts, ins in self.previous_instructions.items()
            if now_ms - ts <= self.cfg.memory_window_ms
        }

        return self.determine_final_instruction(filtered).value
