"""What a served frame costs the card alone: K frames of the device program
captured in one CUDA graph over resident I420 planes, replayed and timed with
CUDA events.

    python -m vision_assist_tpu_torch.tools.diagnose_device_p50 [--frames 8] [--trials 12]

The port of the JAX package's tools/diagnose_device_p50.py, which scanned K
resident frames in one jitted program. Here the K frames of
pipeline/frame_program.py are captured into one ``torch.cuda.CUDAGraph``
(for ``exact_device`` the A* angle cache chained from frame to frame inside
the capture), so one replay runs the K frames' kernels back to back with no
host in the way: a frame's device time is the replay's / K. For the engines
``exact`` (perception and the fields; the host plans), ``wavefront`` (with
the relax kernel) and ``exact_device`` (the A* kernel).

The program creates small constants on the host every call (a lattice mask,
the turn costs, the blur weights, ...), and each such upload from pageable
memory waits for the card: a capture cannot hold it. The tool records those
uploads in a warm-up call and gives the captured program the same device
tensors, after checking at capture that each asks for the same bytes; it
reports how many there are a frame (``h2d_syncs_per_frame``). A capture that
fails on anything else fails the tool, naming the operation.

The replayed payloads (and the final cache) must equal K per-frame calls bit
for bit. The relax and A* wrappers count a launch when the capture records
it, so ``launches`` are the capture's, not the replays'. With ``--device
cpu`` there is no graph: the K chained calls (the graph's CPU counterpart)
are held against K single calls and timed on the host clock. The graph lives
in this tool alone; no serving path uses one.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from vision_assist_tpu_torch.tools import _card

ENGINES = ("exact", "wavefront", "exact_device")


class HoistUploads(TorchFunctionMode):
    """Uploads of host data to the card (``torch.tensor(..., device=cuda)``,
    ``cpu_tensor.to(cuda)``): recorded in order while ``recording``, then
    handed back in the same order, each checked to ask for the same bytes."""

    def __init__(self):
        super().__init__()
        self.store: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.recording = True
        self.position = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        host = self._upload_source(func, args, kwargs)
        if host is None:
            return func(*args, **kwargs)
        if self.recording:
            out = func(*args, **kwargs)
            self.store.append((host, out))
            return out
        if self.position >= len(self.store):
            raise RuntimeError("capture: an upload the warm-up call did not make")
        want, out = self.store[self.position]
        self.position += 1
        if want.dtype != host.dtype or want.shape != host.shape \
                or not torch.equal(want, host):
            raise RuntimeError(f"capture: {func.__name__} uploads other bytes "
                               "than in the warm-up call")
        return out

    @staticmethod
    def _upload_source(func, args, kwargs) -> torch.Tensor | None:
        """The host tensor that ``func`` would upload to the card, or None."""
        if func in (torch.tensor, torch.as_tensor):
            device = kwargs.get("device")
            if device is None or torch.device(device).type != "cuda":
                return None
            with torch._C.DisableTorchFunction():
                return torch.tensor(args[0], dtype=kwargs.get("dtype"))
        if func is torch.Tensor.to and args and isinstance(args[0], torch.Tensor) \
                and args[0].device.type == "cpu":
            device = torch._C._nn._parse_to(*args[1:], **kwargs)[0]
            if device is not None and device.type == "cuda":
                return args[0].detach().clone()
        return None


def _chain(device_fn, planes: torch.Tensor, cache):
    """K frames of the program, the cache chained: (payloads (K, N), cache)."""
    payloads = []
    for k in range(planes.shape[0]):
        if cache is None:
            payloads.append(device_fn(planes[k]))
        else:
            payload, cache = device_fn(planes[k], cache)
            payloads.append(payload)
    return torch.stack(payloads), cache


def _launch_counts() -> dict:
    from vision_assist_tpu_torch.ops import cuda_astar, cuda_sweep, cuda_wavefront

    return {"relax": cuda_wavefront.launches, "astar": cuda_astar.launches,
            "sweep": cuda_sweep.launches}


def _reset_launches() -> None:
    from vision_assist_tpu_torch.ops import cuda_astar, cuda_sweep, cuda_wavefront

    cuda_wavefront.reset_launches()
    cuda_astar.reset_launches()
    cuda_sweep.reset_launches()


def measure_engine(engine: str, seg, frames: np.ndarray, trials: int,
                   device: torch.device) -> dict:
    """One engine's row: the graph (or its CPU counterpart) held against the
    per-frame calls, then timed."""
    from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.planning.device_astar import empty_cache

    fp = FrameProcessor(_card.served_config(engine), segmenter=seg, device=device)
    fp._ensure_program()
    device_fn = fp._device_fn
    k = len(frames)
    planes = torch.from_numpy(np.stack([bgr_to_i420_host(f) for f in frames])
                              ).to(device)
    cache0 = empty_cache(device) if engine == "exact_device" else None

    # The per-frame calls, one by one: the reference the chain must equal.
    ref, cache = [], cache0
    for i in range(k):
        if cache is None:
            ref.append(device_fn(planes[i]))
        else:
            payload, cache = device_fn(planes[i], cache)
            ref.append(payload)
    ref_payloads, ref_cache = torch.stack(ref), cache

    row: dict = {"frames": k}
    if device.type == "cuda":
        hoist = HoistUploads()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), hoist:
            _chain(device_fn, planes, cache0)         # warm-up; records uploads
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        hoist.recording = False
        _reset_launches()
        graph = torch.cuda.CUDAGraph()
        try:
            with hoist, torch.cuda.graph(graph):
                out_payloads, out_cache = _chain(device_fn, planes, cache0)
        except Exception as e:
            raise RuntimeError(f"{engine}: the CUDA graph capture failed: "
                               f"{type(e).__name__}: {e}") from e
        row["launches"] = _launch_counts()
        row["h2d_syncs_per_frame"] = len(hoist.store) / k
        graph.replay()
        torch.cuda.synchronize(device)
        replay = lambda: graph.replay()                  # noqa: E731
    else:
        _reset_launches()
        out_payloads, out_cache = _chain(device_fn, planes, cache0)
        row["launches"] = _launch_counts()
        row["h2d_syncs_per_frame"] = 0.0
        replay = lambda: _chain(device_fn, planes, cache0)  # noqa: E731
    equal = torch.equal(out_payloads, ref_payloads) and (
        ref_cache is None or torch.equal(out_cache.view(torch.int32),
                                         ref_cache.view(torch.int32)))
    row["payloads_equal_per_frame_calls"] = bool(equal)
    if not equal:
        raise AssertionError(f"{engine}: the replayed payloads differ from "
                             f"{k} per-frame calls")
    times = [_card.device_ms(replay, 1, device, warmup=0) for _ in range(trials)]
    row["replay_device_ms"] = _card.percentiles(times)
    row["frame_device_ms"] = _card.percentiles(np.asarray(times) / k)
    return row


def main(argv: list[str] | None = None) -> int:
    ap = _card.parser(__doc__)
    ap.add_argument("--frames", type=int, default=8, help="K frames a graph")
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--engines", nargs="+", default=list(ENGINES), choices=ENGINES)
    args = ap.parse_args(argv)
    _card.check_out(args.out)
    dev = _card.require(args.device)
    seg = _card.flagship_segmenter(dev)
    frames = _card.bench_frames(args.frames)
    engines = {e: measure_engine(e, seg, frames, args.trials, dev)
               for e in args.engines}
    return _card.finish({"tool": "diagnose_device_p50", "engines": engines,
                         **_card.card_stamp(dev)}, args.out)


if __name__ == "__main__":
    sys.exit(main())
