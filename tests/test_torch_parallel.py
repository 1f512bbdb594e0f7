"""The port's parallel layer (``parallel/mesh.py``, ``parallel/distributed.py``,
``parallel/train_step.py``, ``MultiStreamProcessor(mesh=...)``, ``dryrun.py``)
against the JAX package's, on the CPU.

It mirrors tests/test_distributed.py: the environment contract, the loader's
per-process parameters (equal to JAX's), ``globalize_batch``, the mdl=2
mask assembly against the replicated one (rtol 1e-5, atol 1e-4, as JAX's
test holds it), and a real two-process step: two gloo processes
(``tests/torch_dp_worker.py``, the rendezvous a file under ``tmp_path`` so
that test workers never race for a port, each process with its own timeout)
run one data-parallel step of yolov8n-seg at imgsz 64 from the trained
checkpoint on a global batch of 4, equal to the one-process step and to the
JAX step on the same global batch within the 1e-5 of
``test_six_train_steps_match_jax_and_lower_the_loss``. Then the sharded
serving path against ``mesh=None`` and JAX's with a mesh, and ``dryrun(2)``.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from tests import torch_dp_worker as worker  # noqa: E402
from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names  # noqa: E402
from vision_assist_tpu.models import train as jt  # noqa: E402
from vision_assist_tpu.models.checkpoint import load_variables as jax_load_variables  # noqa: E402
from vision_assist_tpu.models.decode import Detections as JaxDetections  # noqa: E402
from vision_assist_tpu.models.decode import assemble_masks as jax_assemble_masks  # noqa: E402
from vision_assist_tpu.models.losses import LossConfig as JaxLossConfig  # noqa: E402
from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg  # noqa: E402
from vision_assist_tpu.parallel import distributed as jdist  # noqa: E402
from vision_assist_tpu.parallel import mesh as jmesh  # noqa: E402
from vision_assist_tpu.pipeline.multi_stream import (  # noqa: E402
    MultiStreamProcessor as JaxMultiStreamProcessor,
)
from vision_assist_tpu_torch import config, dryrun  # noqa: E402
from vision_assist_tpu_torch.models import yolo as ty  # noqa: E402
from vision_assist_tpu_torch.models.decode import assemble_masks  # noqa: E402
from vision_assist_tpu_torch.models.losses import LossConfig  # noqa: E402
from vision_assist_tpu_torch.models.train import create_train_state, make_train_step  # noqa: E402
from vision_assist_tpu_torch.parallel import distributed  # noqa: E402
from vision_assist_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 300


# -- the environment contract --------------------------------------------------------------

def test_noop_without_env(monkeypatch):
    monkeypatch.delenv("VAT_COORDINATOR", raising=False)
    assert distributed.maybe_initialize() is False
    # Idempotent, still a no-op, and never touches torch.distributed.
    assert distributed.maybe_initialize("cpu") is False
    assert not torch.distributed.is_initialized()


def test_process_info_single_process():
    assert distributed.process_info() == jdist.process_info() == (0, 1)


def test_env_contract_documented():
    src = pathlib.Path(distributed.__file__).read_text()
    for var in ("VAT_COORDINATOR", "VAT_NUM_PROCESSES", "VAT_PROCESS_ID"):
        assert var in src


def test_local_loader_params_single_process_identity():
    assert distributed.local_loader_params(32, seed=7) == \
        jdist.local_loader_params(32, seed=7) == (32, 7)


def test_local_loader_params_divisibility(monkeypatch):
    for mod in (distributed, jdist):
        monkeypatch.setattr(mod, "process_info", lambda: (1, 3))
        with pytest.raises(ValueError):
            mod.local_loader_params(32)


@pytest.mark.parametrize("pidx", range(4))
def test_local_loader_params_multi_process_contract(monkeypatch, pidx):
    """Each of four processes gets JAX's (batch, seed): seed + 1000003 * pidx."""
    for mod in (distributed, jdist):
        monkeypatch.setattr(mod, "process_info", lambda: (pidx, 4))
    got = distributed.local_loader_params(32, seed=5)
    assert got == jdist.local_loader_params(32, seed=5) == (8, 5 + 1000003 * pidx)


def test_globalize_batch_dp_sharded():
    """Single-process: the local rows are the global batch, placed on the
    rank's device, bit-identical; ``shard_batch`` splits them over dp into
    contiguous pieces, as JAX's dp sharding does."""
    mesh = tmesh.make_mesh(8, devices=["cpu"] * 8)
    batch = {"images": np.arange(8 * 4 * 4 * 3, dtype=np.uint8).reshape(8, 4, 4, 3),
             "valid": np.ones((8, 5), bool)}
    out = distributed.globalize_batch(batch, mesh)
    jout = jdist.globalize_batch(batch, jmesh.make_mesh(8))
    pieces = tmesh.shard_batch(batch, mesh)
    for k, v in batch.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(jout[k]), v)
        assert pieces[k].shape == (8, 1)
        for (i, _), piece in np.ndenumerate(pieces[k]):
            np.testing.assert_array_equal(
                piece.numpy(), np.asarray(jout[k].addressable_shards[i].data))


def test_mesh_shape_and_rules():
    """make_mesh's axes and its ValueError; param_partition_spec splits Cout of
    a 4-D kernel as JAX's rule does (Cout last in Flax, first here, second
    for a transposed convolution)."""
    mesh = tmesh.make_mesh(8, mdl=2, devices=["cpu"] * 8)
    jm = jmesh.make_mesh(8, mdl=2)
    assert mesh.shape == dict(jm.shape) == {"dp": 4, "mdl": 2}
    assert [mesh.coords(r) for r in (0, 1, 2, 7)] == [(0, 0), (0, 1), (1, 0), (3, 1)]
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="divisible"):
            mod.make_mesh(6, mdl=4, **({"devices": ["cpu"] * 6} if mod is tmesh else {}))
    for cout in (2, 3, 4, 6, 64):
        for mdl in (1, 2, 4):
            want = jmesh.param_partition_spec((), np.zeros((3, 3, 8, cout)), mdl)
            got = tmesh.param_partition_spec("", np.zeros((cout, 8, 3, 3)), mdl)
            got_t = tmesh.param_partition_spec("", np.zeros((8, cout, 2, 2)), mdl, 1)
            split = tuple(want) == (None, None, None, "mdl")
            assert got == (("mdl",) if split else ())
            assert got_t == ((None, "mdl") if split else ())
    assert tmesh.param_partition_spec("", np.zeros(64), 2) == ()


# -- two processes -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The outputs of the two gloo ranks of tests/torch_dp_worker.py."""
    out = tmp_path_factory.mktemp("ranks")
    procs = []
    for rank in range(2):
        env = dict(os.environ, VAT_COORDINATOR=f"file://{out / 'rendezvous'}",
                   VAT_NUM_PROCESSES="2", VAT_PROCESS_ID=str(rank),
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dp_worker.py"), str(out)],
            env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        for rank, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} timed out after {WORKER_TIMEOUT} s")
            if p.returncode != 0:
                pytest.fail(f"rank {rank} failed rc={p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_mdl_proto_einsum_consumer(two_ranks):
    """The mask assembly with its 32 prototypes split over two ranks (one
    all-reduce) equals the replicated assembly, the port's and JAX's."""
    coeffs, protos, boxes, valid = worker.einsum_inputs()
    ref = assemble_masks(torch.from_numpy(protos).permute(2, 0, 1),
                         worker.detections(coeffs, boxes, valid), (160, 160)).numpy()
    d = len(coeffs)
    jref = np.asarray(jax_assemble_masks(
        jnp.asarray(protos), JaxDetections(
            boxes=jnp.asarray(boxes), scores=jnp.ones(d, jnp.float32),
            classes=jnp.zeros(d, jnp.int32), coeffs=jnp.asarray(coeffs),
            valid=jnp.asarray(valid)), (160, 160)))
    for r in two_ranks:
        np.testing.assert_allclose(r["masks"], ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(r["masks"], jref, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(two_ranks[0]["masks"], two_ranks[1]["masks"])


@pytest.fixture(scope="module")
def one_process_step():
    """The port's one-process step on the global batch, from the checkpoint."""
    model = worker.trained_model()
    state = create_train_state(model, worker.TCFG, 10, device="cpu")
    state, metrics = make_train_step(model, LossConfig(mask_topk=worker.TOPK),
                                     worker.TCFG)(state, worker.global_batch())
    return model, state, metrics


@pytest.fixture(scope="module")
def jax_step():
    """JAX's step on the global batch from the same checkpoint (params, EMA
    and batch statistics restored), as the port's names: (loss, params and
    batch statistics, EMA)."""
    model = JaxYoloSeg(arch="yolov8n-seg", num_classes=1, dtype=jnp.float32)
    jcfg = jt.TrainConfig(imgsz=worker.S, batch_size=worker.GLOBAL_BS, lr0=0.01,
                          warmup_epochs=0)
    restored = jax_load_variables(worker.TRAINED)
    state = jt.create_train_state(model, jax.random.PRNGKey(0), jcfg, 10)
    state = state.replace(
        params=serialization.from_state_dict(state.params, restored["params"]),
        ema_params=serialization.from_state_dict(state.ema_params, restored["params"]),
        batch_stats=serialization.from_state_dict(state.batch_stats,
                                                  restored["batch_stats"]))
    step = jt.make_train_step(model, JaxLossConfig(mask_topk=worker.TOPK), jcfg)
    state, metrics = step(state, {k: jnp.asarray(v)
                                  for k, v in worker.global_batch().items()})
    tmodel = ty.YoloSeg("yolov8n-seg", dtype=torch.float32, param_dtype=torch.float32)
    conv = ty.convert_flax_variables(jax.tree.map(np.array, {
        "params": state.params, "batch_stats": state.batch_stats}), tmodel)
    ema = ty.convert_flax_variables(jax.tree.map(np.array, {
        "params": state.ema_params, "batch_stats": state.batch_stats}), tmodel)
    return float(metrics["loss"]), conv, ema


class TestRealTwoProcess:
    """Two gloo processes, one data-parallel step (mesh (2, 1), 2 images a
    rank, BatchNorm statistics and loss normalisers all-reduced)."""

    def test_two_process_step_matches_single_process(self, two_ranks, one_process_step):
        model, state, metrics = one_process_step
        want = model.state_dict()
        for r in two_ranks:
            assert r["world"] == 2 and r["local_bs"] == worker.GLOBAL_BS // 2
            assert r["step"] == state.step == 1
            for k in ("loss", "box", "seg", "cls", "dfl", "fg_per_img"):
                np.testing.assert_allclose(r[f"m:{k}"], float(metrics[k]),
                                           rtol=1e-5, err_msg=k)
            for k, v in want.items():
                np.testing.assert_allclose(r[f"p:{k}"], v.numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=k)
            for k, v in state.ema_params.items():
                np.testing.assert_allclose(r[f"e:{k}"], v.numpy(), rtol=0,
                                           atol=1e-5, err_msg=k)
            np.testing.assert_allclose(r["trace"], state.trace.numpy(), rtol=0,
                                       atol=5e-4)
        # Every rank took the same update.
        for k in two_ranks[0]:
            np.testing.assert_array_equal(two_ranks[0][k], two_ranks[1][k], err_msg=k)

    def test_two_process_step_matches_jax(self, two_ranks, jax_step):
        loss, params, ema = jax_step
        r = two_ranks[0]
        np.testing.assert_allclose(r["m:loss"], loss, rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(r[f"p:{k}"], v.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        for k in (k for k in ema if f"e:{k}" in r):
            np.testing.assert_allclose(r[f"e:{k}"], ema[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


# -- serving and the dry run ---------------------------------------------------------------

@pytest.mark.parametrize("engine", ["exact", "wavefront"])
def test_multi_stream_mesh_matches_jax(engine):
    """14 streams (the 13 scenarios and the first again) over a 2-device
    mesh: answers, peaks and path cells equal to mesh=None and to JAX's
    MultiStreamProcessor over a 2-device JAX mesh."""
    names = scenario_names() + scenario_names()[:1]
    occ = np.stack([load_scenario(n) for n in names])
    pf = dict(engine=engine)
    cfg = config.replay_config().replace(num_streams=len(names),
                                         pathfinder=config.PathFinderConfig(**pf))
    jcfg = jconfig.replay_config().replace(num_streams=len(names),
                                           pathfinder=jconfig.PathFinderConfig(**pf))

    def digest(results):
        return [(r.final_answer, [(p.centre.x, p.centre.y) for p in r.peaks],
                 [[(c.row, c.col) for c in p.cells] for p in r.paths]) for r in results]

    got = []
    for m in (tmesh.make_mesh(2, devices=["cpu"] * 2), None):
        msp = MultiStreamProcessor(cfg, mesh=m, replay_rounding=True, device="cpu")
        got.append(digest(msp.process_occupancies(occ, now_ms=0)))
        msp.close()
    jmsp = JaxMultiStreamProcessor(jcfg, mesh=jmesh.make_mesh(2), replay_rounding=True)
    want = digest(jmsp.process_occupancies(occ, now_ms=0))
    jmsp.close()
    assert got[0] == got[1] == want


def test_dryrun_two_processes():
    """dryrun(2): a (1, 2) mesh, the wide kernels stored as slices; the step
    equals one process's, the 13 scenarios' answers the single stream's."""
    assert dryrun.TIMEOUT == WORKER_TIMEOUT
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="need 2 cards"):
            dryrun.dryrun_multichip(2)              # NCCL by default
    outs = dryrun.dryrun_multichip(2, device="cpu")
    assert len(outs) == 2
    assert all("train ok: mesh=(1,2) processes=2" in o for o in outs)
    assert "serving ok: 14 streams over 2 cpu devices" in outs[0]
