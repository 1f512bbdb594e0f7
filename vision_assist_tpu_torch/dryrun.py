"""Multi-process dry run of the parallel layer.

Counterpart of ``__graft_entry__.py::dryrun_multichip``. ``dryrun_multichip(n)``
starts ``n`` processes joined into one group (the rendezvous a file in a
temporary directory) on a (dp, mdl) mesh, mdl = 2 when n is even: by default
NCCL, one rank a card (it needs ``n`` cards), or with ``device="cpu"`` gloo on
the host's CPU. On the cards TF32 is off, so that the float32 comparisons
below hold. Each process runs:

* one data-parallel train step of yolov8n-seg at imgsz 64, one image a dp
  rank (``parallel/train_step.py``; with mdl = 2 the wide kernels stored as
  output-channel slices), asserted equal to a one-process step of the same
  model on the whole batch: the loss within rtol 1e-5, the all-gathered
  parameters and the batch statistics within atol 1e-5;
* on rank 0, the serving path: the 13 scenarios (cycled up to a multiple of n)
  as streams of ``MultiStreamProcessor(mesh=...)`` over an (n, 1) mesh of the
  n cards (or n CPU devices) with ``replay_rounding``, each answer asserted equal to that of a
  fresh single-stream ``FrameProcessor`` on the stream's scenario.

Each process has TIMEOUT seconds; on a failure or a timeout every process
is stopped and RuntimeError raised.

    python -m vision_assist_tpu_torch.dryrun 2                 # two cards
    python -m vision_assist_tpu_torch.dryrun 2 --device cpu    # gloo
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 300.0         # seconds for each process


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[str]:
    """Run the dry run in ``n_devices`` processes, NCCL over as many cards
    for ``device`` "cuda", gloo for "cpu"; returns each rank's standard
    output."""
    device = torch.device(device).type
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip: {n_devices} processes need {n_devices} cards, "
            f"found {torch.cuda.device_count()}; pass device='cpu' for gloo")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(n_devices):
            env = dict(os.environ, VAT_COORDINATOR=f"file://{tmp}/rendezvous",
                       VAT_NUM_PROCESSES=str(n_devices), VAT_PROCESS_ID=str(rank))
            if device == "cpu":
                env["CUDA_VISIBLE_DEVICES"] = ""
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "vision_assist_tpu_torch.dryrun",
                 "--inner", str(n_devices), "--device", device],
                cwd=REPO, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        deadline = time.monotonic() + TIMEOUT
        outs, failed = [], []
        try:
            for rank, p in enumerate(procs):
                try:
                    out, err = p.communicate(
                        timeout=max(deadline - time.monotonic(), 1.0))
                except subprocess.TimeoutExpired:
                    failed.append(f"rank {rank} timed out after {TIMEOUT} s")
                    break
                outs.append(out)
                if p.returncode != 0:
                    failed.append(f"rank {rank} rc={p.returncode}:\n{err[-3000:]}")
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if failed:
            raise RuntimeError("dryrun_multichip failed: " + "; ".join(failed))
        return outs


def _train_batch(batch: int, imgsz: int) -> dict[str, np.ndarray]:
    """The JAX dry run's batch: random images, one box a slot, a mask."""
    rng = np.random.default_rng(0)
    mh = imgsz // 4
    out = {
        "images": rng.integers(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8),
        "masks": np.zeros((batch, mh, mh), np.uint8),
        "boxes": np.tile(np.array([[8.0, 8.0, 48.0, 56.0]], np.float32),
                         (batch, 4, 1)),
        "classes": np.zeros((batch, 4), np.int32),
        "valid": np.ones((batch, 4), bool),
    }
    out["masks"][:, 2:14, 2:12] = 1
    return out


def _dryrun_train(mesh, device: torch.device) -> str:
    from vision_assist_tpu_torch.models.losses import LossConfig
    from vision_assist_tpu_torch.models.train import (
        TrainConfig,
        create_train_state,
        make_train_step,
    )
    from vision_assist_tpu_torch.models.yolo import YoloSeg
    from vision_assist_tpu_torch.parallel.distributed import process_info
    from vision_assist_tpu_torch.parallel.train_step import (
        create_dp_train_state,
        gathered_state_dict,
    )

    dp, mdl = mesh.shape["dp"], mesh.shape["mdl"]
    imgsz = 64
    cfg = TrainConfig(imgsz=imgsz, batch_size=dp, lr0=0.01, warmup_epochs=0)
    loss_cfg = LossConfig(mask_topk=16)
    batch = _train_batch(dp, imgsz)

    def model():
        torch.manual_seed(0)             # the same weights on every rank
        return YoloSeg("yolov8n-seg", num_classes=1, dtype=torch.float32,
                       param_dtype=torch.float32)

    sharded = model()
    state, coll = create_dp_train_state(sharded, cfg, 10, mesh, device=device)
    rows = slice(coll.dp_index, coll.dp_index + 1)
    step = make_train_step(sharded, loss_cfg, cfg, coll)
    state, metrics = step(state, {k: v[rows] for k, v in batch.items()})
    loss = float(metrics["loss"])
    got = gathered_state_dict(sharded)
    if not np.isfinite(loss) or state.step != 1:
        raise AssertionError(f"loss {loss}, step {state.step}")

    single = model()
    _, metrics1 = make_train_step(single, loss_cfg, cfg)(
        create_train_state(single, cfg, 10, device=device), batch)
    loss1 = float(metrics1["loss"])
    want = single.state_dict()
    if abs(loss - loss1) > 1e-5 * abs(loss1):
        raise AssertionError(f"sharded loss {loss} != single-process {loss1}")
    diff = max(float((got[k] - v).abs().max()) for k, v in want.items()
               if v.is_floating_point())
    if set(got) != set(want) or diff > 1e-5:
        raise AssertionError(f"parameters or batch statistics {diff} apart")
    return (f"dryrun_multichip train ok: mesh=({dp},{mdl}) processes="
            f"{process_info()[1]} loss={loss:.6f} (one process {loss1:.6f}) "
            f"max |param/stat diff|={diff:.3g}")


def _dryrun_serving(n: int, device: str) -> str:
    from vision_assist_tpu_torch.config import replay_config
    from vision_assist_tpu_torch.io.scenarios import load_scenario, scenario_names
    from vision_assist_tpu_torch.parallel.mesh import make_mesh
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor

    names = scenario_names()
    names = (names * n)[:-(-len(names) // n) * n]       # a multiple of n
    occ = np.stack([load_scenario(s) for s in names])
    devices = ([torch.device("cuda", i) for i in range(n)] if device == "cuda"
               else [torch.device("cpu")] * n)
    msp = MultiStreamProcessor(replay_config().replace(num_streams=len(names)),
                               mesh=make_mesh(n, mdl=1, devices=devices),
                               replay_rounding=True, device=devices[0])
    try:
        results = msp.process_occupancies(occ, now_ms=0)
    finally:
        msp.close()
    for name, res in zip(names, results):
        # A fresh processor a stream: each stream saw one frame, with its
        # own instruction memory and its own exact engine's angle cache.
        fp = FrameProcessor(replay_config(), replay_rounding=True,
                            device=devices[0])
        want = fp.process_occupancy(load_scenario(name), now_ms=0)
        if res.final_answer != want.final_answer:
            raise AssertionError(f"{name}: sharded answer {res.final_answer!r} != "
                                 f"single-stream {want.final_answer!r}")
    return (f"dryrun_multichip serving ok: {len(names)} streams over {n} "
            f"{device} devices; answers match single-stream on {len(set(names))} scenarios")


def _inner(n: int, device: str) -> None:
    import torch.distributed as dist

    from vision_assist_tpu_torch.parallel.distributed import (
        maybe_initialize,
        process_device,
    )
    from vision_assist_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // n)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not maybe_initialize(device):
        raise RuntimeError("the dry run's worker needs VAT_COORDINATOR")
    try:
        mdl = 2 if n % 2 == 0 and n > 1 else 1
        print(_dryrun_train(make_mesh(n, mdl=mdl), process_device(device)),
              flush=True)
        if dist.get_rank() == 0:
            print(_dryrun_serving(n, device), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("n", type=int, nargs="?", default=2,
                    help="processes, one a card (or a CPU process with --device cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL over n cards; cpu: gloo on the host")
    ap.add_argument("--inner", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.inner is not None:
        _inner(args.inner, args.device)
        return 0
    t0 = time.perf_counter()
    for out in dryrun_multichip(args.n, args.device):
        print(out, end="")
    print(f"dryrun_multichip: {args.n} {args.device} processes in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
