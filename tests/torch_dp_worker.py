"""One rank of the two-process gloo checks in tests/test_torch_parallel.py.

Started with VAT_COORDINATOR (a ``file://`` rendezvous), VAT_NUM_PROCESSES=2
and VAT_PROCESS_ID; writes ``rank{r}.npz`` into the directory given as its
argument:

* ``masks``: ``assemble_masks_mdl`` with the 32 prototypes split over the two
  ranks as mdl (one all-reduce), on the seeded inputs of :func:`einsum_inputs`;
* one data-parallel train step of yolov8n-seg at imgsz 64 from the trained
  checkpoint on the global batch of :func:`global_batch` (4 images, 2 a rank,
  mesh (2, 1)): ``loss`` and the metrics, and the state after it (``p:``
  parameters and batch statistics, ``e:`` the EMA, ``trace``, ``step``).

Imports torch and the port only.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from vision_assist_tpu_torch.data.loader import BatchLoader  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import WalkwaySet  # noqa: E402
from vision_assist_tpu_torch.models import yolo  # noqa: E402
from vision_assist_tpu_torch.models.checkpoint import load_variables  # noqa: E402
from vision_assist_tpu_torch.models.decode import Detections  # noqa: E402
from vision_assist_tpu_torch.models.losses import LossConfig  # noqa: E402
from vision_assist_tpu_torch.models.train import TrainConfig, make_train_step  # noqa: E402

TRAINED = REPO / "assets" / "weights" / "v8n_256_study_best.msgpack"
S, GLOBAL_BS, TOPK = 64, 4, 16
TCFG = TrainConfig(imgsz=S, batch_size=GLOBAL_BS, lr0=0.01, warmup_epochs=0)


def einsum_inputs():
    """(coeffs (D, nm), protos (Hp, Wp, nm) in the JAX layout, boxes, valid),
    as tests/test_distributed.py draws them."""
    rng = np.random.default_rng(0)
    d, nm, hp, wp = 16, 32, 40, 40
    coeffs = rng.standard_normal((d, nm)).astype(np.float32)
    protos = rng.standard_normal((hp, wp, nm)).astype(np.float32)
    boxes = np.abs(rng.standard_normal((d, 4))).astype(np.float32) * 100
    boxes[:, 2:] += boxes[:, :2] + 50
    return coeffs, protos, boxes, np.ones(d, bool)


def detections(coeffs, boxes, valid) -> Detections:
    d = len(coeffs)
    return Detections(boxes=torch.from_numpy(boxes), scores=torch.ones(d),
                      classes=torch.zeros(d, dtype=torch.int32),
                      coeffs=torch.from_numpy(coeffs), valid=torch.from_numpy(valid))


def global_batch() -> dict[str, np.ndarray]:
    loader = BatchLoader(WalkwaySet(GLOBAL_BS, 160, 160, seed=1), batch_size=GLOBAL_BS,
                         imgsz=S, augment=False)
    return loader._pack(np.arange(GLOBAL_BS))


def trained_model() -> yolo.YoloSeg:
    model = yolo.YoloSeg("yolov8n-seg", dtype=torch.float32, param_dtype=torch.float32)
    model.load_state_dict(yolo.convert_flax_variables(load_variables(TRAINED), model))
    return model


def main(out_dir: str) -> None:
    import torch.distributed as dist

    from vision_assist_tpu_torch.parallel.distributed import (
        globalize_batch,
        local_loader_params,
        maybe_initialize,
        process_info,
    )
    from vision_assist_tpu_torch.parallel.mesh import assemble_masks_mdl, make_mesh
    from vision_assist_tpu_torch.parallel.train_step import create_dp_train_state

    torch.set_num_threads(2)
    assert maybe_initialize("cpu")
    rank, world = process_info()
    out = {}

    coeffs, protos, boxes, valid = einsum_inputs()
    out["masks"] = assemble_masks_mdl(
        torch.from_numpy(protos).permute(2, 0, 1), detections(coeffs, boxes, valid),
        (160, 160), mdl_index=rank, mdl=world).numpy()

    mesh = make_mesh()
    local_bs, _ = local_loader_params(GLOBAL_BS)
    rows = slice(rank * local_bs, (rank + 1) * local_bs)
    batch = globalize_batch({k: v[rows] for k, v in global_batch().items()}, mesh)
    model = trained_model()
    state, coll = create_dp_train_state(model, TCFG, 10, mesh, device="cpu")
    state, metrics = make_train_step(model, LossConfig(mask_topk=TOPK), TCFG,
                                     coll)(state, batch)
    out.update({f"m:{k}": v.numpy() for k, v in metrics.items()})
    out.update({f"p:{k}": v.detach().numpy() for k, v in model.state_dict().items()})
    out.update({f"e:{k}": v.numpy() for k, v in state.ema_params.items()})
    out.update(trace=state.trace.numpy(), step=np.int64(state.step),
               local_bs=np.int64(local_bs), world=np.int64(world))
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
