"""The precision control of the check: the plain reference put in the
program's place one precision step below what the configuration states,
read by the same numbers as the program.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 [--device cuda]

The segmenter's control is the reference chain with every convolution and
matmul operand rounded to float8 e4m3 (the configuration states bf16), held
against the float32 reference on the cell's frame pool: by its detections
(``conf_gap``, ``occ_share``, ``ndet_gap``) for trained weights, by its head
outputs (``head_gap``) for seeded ones. For seeded weights the chain after
the model (decode, NMS, masks, the lattice for an instance head; the
sampled logits and the lattice for a per-pixel one; float32 in the
program) has a control of its own, which sets the upper readings of its
three numbers there: that chain with each stage's results rounded to
bfloat16, on the float32 reference's head outputs, held against the
float32 chain on the same outputs. The planner's control is the reference
planner with its penalty field and path costs rounded one step below the
engine's precision (float32 for the host engine's float64, bfloat16 for
the device A*'s float32), held against the float64 planner, each stream
through its frames in order, from the float32 reference's lattices. Prints
one JSON line a seed; the weights are made once a process. The
benchmark's own runs never run it; it sets the upper readings the limits
in ``benchmark/limits/`` are chosen under.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def to_float32(x):
    import numpy as np

    return np.asarray(x, np.float32).astype(np.float64)


def to_bf16(x):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


def fake_fp8(x):
    """x rounded to float8 e4m3 with one scale a tensor (its largest magnitude
    mapped to 448, the format's largest finite value), back in float32."""
    import torch

    scale = x.detach().abs().amax().clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def bf16_tensor(x):
    import torch

    return x.to(torch.bfloat16).float()


def control_numbers(root, cell, seed: int, device, variables=None) -> dict:
    """The control's numbers on the pool of ``seed``, with the weights
    ``variables`` (the configuration's own where None)."""
    from benchmark.harness.check import (
        conf_threshold,
        head_gap,
        planner_numbers,
        reference_segmentation,
        segmenter_numbers,
    )
    from benchmark.harness.frames import make_pool, stream_offsets
    from benchmark.harness.serve import Answer
    from benchmark.harness.weights import flax_tree, seeded
    from benchmark.reference.plan import ReferencePlanner

    t = cell.traffic
    pool = make_pool(t, seed)
    heads = seeded(cell.config)
    if variables is None:
        variables = flax_tree(root, cell.config, device)
    ref = reference_segmentation(root, cell.config, variables, pool, device, heads=heads)
    low = reference_segmentation(root, cell.config, variables, pool, device, quant=fake_fp8,
                                 heads=heads)
    hw, g = (t["frame_height"], t["frame_width"]), cell.config["grid_size"]

    def answers(seg, round_cost=None):
        out = []
        for s, off in enumerate(stream_offsets(t)):
            planner = ReferencePlanner(hw, g, t["engine"] == "exact_device", round_cost)
            for seq in range(len(pool)):
                i = (off + seq) % len(pool)
                r = seg[i]
                p = planner.frame(r.occupancy, r.n_detections, seq * t["frame_interval_ms"])
                out.append(Answer(s, seq, i, seq * t["frame_interval_ms"], r.occupancy,
                                  r.n_detections, r.best_conf, p.walkable, p.artificial,
                                  p.penalty, p.peaks, p.paths, p.answer))
        return out

    conf = conf_threshold(cell.config), cell.limits["conf_gap"]
    if heads:
        numbers = {"head_gap": head_gap([s.heads for s in low], [s.heads for s in ref])}
        low = reference_segmentation(root, cell.config, variables, pool, device,
                                     rounding=bf16_tensor)
    else:
        numbers = {}
    mine = answers(low)
    numbers.update(segmenter_numbers(mine, [ref[a.pool_index] for a in mine], *conf))
    # The host planner (engine "exact") is float64, the device A* float32.
    lower = to_float32 if t["engine"] == "exact" else to_bf16
    numbers.update(planner_numbers(answers(ref, round_cost=lower), hw, g, t["engine"]))
    numbers["detected_share"] = sum(r.n_detections > 0 for r in ref) / len(ref)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The check's precision control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.cell import load_cell
    from benchmark.harness.weights import flax_tree

    cell = load_cell(ROOT, args.workload)
    device = torch.device(args.device)
    variables = flax_tree(ROOT, cell.config, device)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(ROOT, cell, seed, device, variables)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
