"""Multi-process scale-out, a thin optional layer over ``torch.distributed``.

Counterpart of ``vision_assist_tpu/parallel/distributed.py``. One process
drives one device; :func:`maybe_initialize` joins the processes into one
group (NCCL between cards, gloo on the CPU), after which the mesh
(``parallel/mesh.py``) spans the ranks and the data-parallel train step
(``parallel/train_step.py``) sums over them. Besides initialisation it owns
the data half of the multi-process contract: each process loads its own
slice of the global batch (:func:`local_loader_params`) and places it on
its device (:func:`globalize_batch`); ``train_model.py`` consumes both.

Environment contract:
  VAT_COORDINATOR       the rendezvous: ``host:port`` (``tcp://host:port``),
                        a URL with its scheme (such as ``file:///path``), or
                        ``auto`` for the ``env://`` variables torchrun sets
                        (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
  VAT_NUM_PROCESSES     total process count
  VAT_PROCESS_ID        this process's rank
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def maybe_initialize(device: str | torch.device = "cuda") -> bool:
    """Join the process group when the environment asks for it.

    Returns True when running multi-process (after initialisation), False
    for the ordinary single-process case. Idempotent. The backend is NCCL
    for ``device`` "cuda" (this rank then uses card ``rank % device_count``)
    and gloo for the CPU."""
    coord = os.environ.get("VAT_COORDINATOR")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("maybe_initialize: CUDA requested but not available; "
                           "pass device='cpu' for gloo")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coord == "auto":
        dist.init_process_group(backend, init_method="env://")
    else:
        rank = int(os.environ["VAT_PROCESS_ID"])
        if device.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=coord if "://" in coord else f"tcp://{coord}",
            world_size=int(os.environ["VAT_NUM_PROCESSES"]), rank=rank)
    return True


def process_info() -> tuple[int, int]:
    """(process_index, process_count): (0, 1) when single-process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_device(device: str | torch.device = "cuda") -> torch.device:
    """This process's device: its card (``rank % device_count``) for
    "cuda", else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", process_info()[0] % torch.cuda.device_count())


def local_loader_params(global_batch_size: int, seed: int = 0
                        ) -> tuple[int, int]:
    """(local_batch_size, local_seed) for this process's data loader.

    Each process draws an independent seeded sample stream (disjoint seeds,
    sampling with replacement across processes, as SGD does); together the
    local batches form the global batch."""
    pidx, pcount = process_info()
    if global_batch_size % pcount:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"process_count {pcount}")
    return global_batch_size // pcount, seed + 1000003 * pidx


def globalize_batch(batch: dict, mesh, axis: str = "dp") -> dict:
    """This process's local rows of the global batch, placed on its device.

    The global batch is the concatenation of the local batches over the
    ranks in rank order (rank r's rows follow rank r - 1's); nothing is
    copied between processes, and the data-parallel step's collectives make
    it act on the whole. With mdl > 1 the ranks of one dp row hold the same
    rows (rank r is at dp index r // mdl), so they must be given the same
    local batch."""
    if axis != "dp":
        raise ValueError(f"the batch splits over 'dp', not {axis!r}")
    device = mesh.devices.flat[process_info()[0]]
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
