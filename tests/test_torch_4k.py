"""4K UHD and 1440p frames through every engine of the port, and the lattice
kernels' choice of form.

At grid 20 a 2160x3840 frame is a 108x192 lattice, a 3840x2160 frame
192x108 and a 1440x2560 frame 72x128. Each engine of the port on the CPU
(the kernels' plain versions) gives the JAX package's answer and path cells
on a corridor and a seeded walkway, as tests/test_torch_1080p.py does at
54x96.

On the card the three lattice kernels (relax, sweep, A*) each have a shared
form, whose state lives in one CTA's shared memory, and a global form, whose
per-cell state lives in device memory, for the lattices past that. Traced
with fake CUDA tensors (no card needed), each wrapper takes the shared form
where it fits, the global form past it, the global form at any size when
asked, and raises before any launch past what remains of its cap. The tests
marked ``cuda`` hold each global form bit-equal to its plain twin on the
card; they skip without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.pipeline.frame_processor import (  # noqa: E402
    FrameProcessor as JaxFrameProcessor,
)
from vision_assist_tpu_torch import config  # noqa: E402
from vision_assist_tpu_torch.ops import cuda_astar, cuda_sweep, cuda_wavefront  # noqa: E402
from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor  # noqa: E402
from vision_assist_tpu_torch.planning import device_astar, wavefront  # noqa: E402

torch.set_num_threads(2)

ENGINES = {
    "exact": dict(engine="exact"),
    "exact_device": dict(engine="exact_device"),
    "wavefront": dict(engine="wavefront"),
    "wavefront_kernel": dict(engine="wavefront", use_pallas_relax=True),
}
UHD, UHD_PORTRAIT, QHD_PORTRAIT = (2160, 3840), (3840, 2160), (1440, 2560)
CASES = ([(UHD, e) for e in ENGINES] + [(UHD_PORTRAIT, e) for e in ENGINES]
         + [(QHD_PORTRAIT, "exact_device")])


def corridor(rows: int, cols: int) -> np.ndarray:
    """tests/test_torch_1080p.py's corridor in the lower 36 rows of the
    lattice: up from the bottom a little left of centre, then right; a
    twenty-fourth of the lattice wide (at least 5 cells)."""
    occ = np.zeros((rows, cols), bool)
    width, c0, r0 = max(5, cols // 24), cols * 40 // 96, rows - 36
    occ[r0:, c0:c0 + width] = True
    occ[r0:r0 + width, c0:cols * 56 // 96] = True
    return occ


def walkway(rows: int, cols: int, seed: int = 5) -> np.ndarray:
    """A walkway 4 to 6 cells wide wandering up the lower 36 rows of the
    lattice, seeded."""
    rng = np.random.default_rng(seed)
    occ = np.zeros((rows, cols), bool)
    centre = cols // 2
    for r in range(rows - 1, rows - 37, -1):
        centre = int(np.clip(centre + rng.integers(-2, 3), cols // 8, cols - cols // 8))
        half = int(rng.integers(2, 4))
        occ[r, centre - half:centre + half] = True
    return occ


def _cells(res):
    return [[(c.row, c.col) for c in p.cells] for p in res.paths]


@pytest.mark.parametrize("hw,engine", CASES)
def test_large_frames_answer_as_jax(hw, engine):
    """The port on the CPU against the JAX package at 4K UHD (both
    orientations) for every engine and at 1440p for exact_device: answers
    and path cells equal on a corridor and a seeded walkway."""
    kw = dict(frame_height=hw[0], frame_width=hw[1])
    cfg = config.PipelineConfig(**kw)
    rows, cols = cfg.lattice_rows, cfg.lattice_cols
    assert (rows, cols) == (hw[0] // 20, hw[1] // 20)
    tfp = FrameProcessor(config.PipelineConfig(
        **kw, pathfinder=config.PathFinderConfig(**ENGINES[engine])), device="cpu")
    jfp = JaxFrameProcessor(jconfig.PipelineConfig(
        **kw, pathfinder=jconfig.PathFinderConfig(**ENGINES[engine])))
    for occ in (corridor(rows, cols), walkway(rows, cols)):
        res = tfp.process_occupancy(occ, now_ms=0)
        want = jfp.process_occupancy(occ, now_ms=0)
        assert res.walkable.shape == (rows, cols)
        assert res.paths, "expected at least one path on the lattice"
        assert res.final_answer == want.final_answer
        assert _cells(res) == _cells(want)


# -- the kernels' forms on (fake) CUDA tensors ------------------------------------------


def _fake_cuda(*shapes_and_dtypes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return mode, [torch.zeros(s, dtype=d, device="cuda") for s, d in shapes_and_dtypes]


@pytest.fixture
def recorded(monkeypatch):
    """Each wrapper's launch replaced by a record of the form it was asked
    for; the launch counts zeroed before and after."""
    calls = []
    for mod in (cuda_wavefront, cuda_astar):
        mod.reset_launches()
        monkeypatch.setattr(mod, "_launch", lambda form, *a, mod=mod, **k: calls.append(
            (mod.__name__.rsplit(".", 1)[1], form)))
    yield calls
    for mod in (cuda_wavefront, cuda_astar, cuda_sweep):
        mod.reset_launches()


@pytest.mark.parametrize("rows,cols,form,want", [
    (32, 32, None, "shared"), (54, 96, None, "shared"), (72, 128, None, "shared"),
    (108, 192, None, "global"), (192, 108, None, "global"), (256, 256, None, "global"),
    (32, 32, "global", "global"), (64, 36, "global", "global"), (54, 96, "shared", "shared")])
def test_relax_kernel_takes_its_form(recorded, rows, cols, form, want):
    """The relax kernel's wrapper launches the shared form where the five
    planes fit a block's shared memory (up to 79x140), the global form past
    it (no cap remains), and the global form at any size when asked; the
    launches are counted by form."""
    assert cuda_wavefront.pick_form(rows, cols, form) == want
    if form is None:
        assert (cuda_wavefront.shared_bytes(rows, cols) <= cuda_wavefront.SHARED_CAP) == (
            want == "shared")
    mode, (enter, start, turn) = _fake_cuda(((2, rows, cols), torch.float32),
                                            ((2, 2), torch.int32), ((4, 4), torch.float32))
    with mode:
        dist, passes = cuda_wavefront.relax_field_cuda(enter, start, turn, form=form)
    assert (dist.shape, passes.shape) == ((2, rows, cols, 4), (2,))
    assert recorded == [("cuda_wavefront", want)]
    assert cuda_wavefront.launches == 1
    assert cuda_wavefront.launches_by_form == {"shared": want == "shared",
                                               "global": want == "global"}


def test_relax_kernel_refuses_before_any_launch(recorded):
    """A forced shared form that does not fit, and a form that is not one,
    raise before any launch."""
    mode, (enter, start, turn) = _fake_cuda(((1, 108, 192), torch.float32),
                                            ((1, 2), torch.int32), ((4, 4), torch.float32))
    with mode:
        with pytest.raises(ValueError, match="shared memory"):
            cuda_wavefront.relax_field_cuda(enter, start, turn, form="shared")
        with pytest.raises(ValueError, match="form"):
            cuda_wavefront.relax_field_cuda(enter, start, turn, form="texture")
    assert recorded == [] and cuda_wavefront.launches == 0


@pytest.mark.parametrize("rows,cols,form,want", [
    (32, 32, None, "shared"), (54, 96, None, "shared"), (72, 128, None, "global"),
    (108, 192, None, "global"), (192, 108, None, "global"), (256, 208, None, "global"),
    (32, 32, "global", "global"), (54, 96, "global", "global")])
def test_astar_kernel_takes_its_form(recorded, rows, cols, form, want):
    """The A* kernel's wrapper launches the shared form where the whole
    search fits a block's shared memory (1080p's 54x96, 169,104 B), the
    global form past it (1440p's 72x128, 4K UHD's 108x192: 104,016 B of
    keys and tables, 518,400 B of scratch a stream), and the global form at
    any size when asked."""
    assert cuda_astar.pick_form(rows, cols, form) == want
    assert cuda_astar.shared_bytes(rows, cols, want) <= cuda_astar.SHARED_CAP
    if want == "global" and form is None:
        assert cuda_astar.shared_bytes(rows, cols, "shared") > cuda_astar.SHARED_CAP
    mode, ins = _fake_cuda(((1, rows, cols), torch.bool), ((1, rows, cols), torch.float32),
                           ((1, 2), torch.int32), ((1, 3, 2), torch.int32),
                           ((1, 3), torch.bool), ((1, device_astar.CACHE_SIZE), torch.float32))
    with mode:
        cells, lengths, costs, cache, stats = cuda_astar.astar_paths_cuda(*ins, form=form)
    assert (cells.shape, lengths.shape, stats.shape) == ((1, 3, 512, 2), (1, 3), (1, 3, 2))
    assert recorded == [("cuda_astar", want)]
    assert cuda_astar.launches_by_form == {"shared": want == "shared",
                                           "global": want == "global"}


def test_astar_layouts_and_cap():
    """The byte counts of the two forms, and the cap that remains: the
    global form's keys of the open set and its tables must fit a block's
    shared memory, so 256x208 (53,248 cells) is taken and 256x209 raises
    before any launch, naming shared memory."""
    assert cuda_astar.shared_bytes(54, 96, "shared") == 169104
    assert cuda_astar.shared_bytes(72, 128, "shared") == 285264
    assert cuda_astar.shared_bytes(108, 192, "shared") == 622416
    assert cuda_astar.shared_bytes(108, 192, "global") == 104016
    assert cuda_astar.scratch_bytes(108, 192) == 25 * 108 * 192
    assert cuda_astar.pick_form(256, 208) == "global"
    for rows, cols, form in ((256, 209, None), (256, 256, "global"), (72, 128, "shared")):
        with pytest.raises(ValueError, match="shared memory"):
            cuda_astar.pick_form(rows, cols, form)


def test_astar_kernel_refuses_before_any_launch(recorded):
    mode, ins = _fake_cuda(((1, 256, 209), torch.bool), ((1, 256, 209), torch.float32),
                           ((1, 2), torch.int32), ((1, 1, 2), torch.int32),
                           ((1, 1), torch.bool), ((1, device_astar.CACHE_SIZE), torch.float32))
    with mode:
        with pytest.raises(ValueError, match="shared memory"):
            cuda_astar.astar_paths_cuda(*ins)
    assert recorded == [] and cuda_astar.launches == 0


@pytest.mark.parametrize("rows,cols,form,want", [
    (32, 32, None, ("shared", 1)), (54, 96, None, ("shared", 4)),
    (72, 128, None, ("shared", 7)), (108, 192, None, ("global", 6)),
    (192, 108, None, ("global", 6)), (256, 256, None, ("global", 8)),
    (32, 32, "global", ("global", 1)), (54, 96, "global", ("global", 3)),
    (64, 36, "global", ("global", 2))])
def test_sweep_kernel_takes_its_form(rows, cols, form, want):
    """The sweep kernel's wrapper traces to the shared form's operator where
    a cluster's replicas fit, the global form's past it (4K UHD at 6 CTAs a
    stream, 256x256 at 8), and the global form at any size when asked, at
    the fewest CTAs; one operator, no host sync, no launch."""
    from torch.fx.experimental.proxy_tensor import make_fx

    assert cuda_sweep.launch_plan(rows, cols, 0, form) == want
    mode, (enter, start, turn) = _fake_cuda(((2, rows, cols), torch.float32),
                                            ((2, 2), torch.int32), ((4, 4), torch.float32))
    cuda_sweep.reset_launches()
    with mode:
        graph = make_fx(lambda e, s, t: cuda_sweep.relax_sweep_field_cuda(
            e, s, t, form=form), tracing_mode="fake")(enter, start, turn).graph
    (op,) = [n for n in graph.nodes if "relax_sweep" in str(n.target)]
    assert ("relax_sweep_global" in str(op.target)) == (want[0] == "global")
    assert op.args[-2:] == (rows * cols, want[1])
    assert cuda_sweep.launches == 0 and cuda_sweep.launches_by_form == {"shared": 0,
                                                                        "global": 0}


def test_sweep_kernel_refuses_before_any_launch():
    """Lines longer than 256 cells (5120 px at grid 20) raise in either
    form, as does a forced shared form at 4K UHD, before any launch."""
    mode, (e257, e4k, start, turn) = _fake_cuda(
        ((1, 3, 257), torch.float32), ((1, 108, 192), torch.float32),
        ((1, 2), torch.int32), ((4, 4), torch.float32))
    cuda_sweep.reset_launches()
    with mode:
        for form in (None, "global"):
            with pytest.raises(ValueError, match="lines of 1 to 256"):
                cuda_sweep.relax_sweep_field_cuda(e257, start, turn, form=form)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_sweep.relax_sweep_field_cuda(e4k, start, turn, form="shared")
    assert cuda_sweep.launches == 0


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the global forms have no CPU mode)")
    return torch.device("cuda")


def _field_inputs(rows, cols, b, seed, device):
    rng = np.random.default_rng(seed)
    walk = torch.from_numpy(rng.random((b, rows, cols)) < 0.65).to(device)
    pen = torch.from_numpy(rng.random((b, rows, cols)).astype(np.float32)).to(device) * walk
    start = torch.from_numpy(np.stack([rng.integers(0, rows, b), rng.integers(0, cols, b)],
                                      -1).astype(np.int32)).to(device)
    turn = wavefront._scaled_turn(20, 1e-4, 30.0, 1.5, 90.0, device)
    return wavefront.enter_cost(walk, pen, 20, 0.5), start, turn


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,b", [(32, 32, 8), (54, 96, 1), (108, 192, 1),
                                         (192, 108, 2), (144, 256, 2), (256, 256, 1),
                                         (256, 1, 2), (1, 256, 2)])
def test_global_wavefront_forms_bit_equal_on_card(cuda, rows, cols, b):
    """The relax and sweep kernels' global forms (forced, and the wrapper's
    own pick) give their twins' fields, and the sweep its passes, up to
    lines of 256 cells on both sides (2880x5120 and 5120x5120 frames)."""
    enter, start, turn = _field_inputs(rows, cols, b, rows + cols, cuda)
    ref, _ = wavefront.relax_field(enter, start, turn)
    ref_sweep, ref_passes = wavefront.relax_sweep_field(enter, start, turn)
    for form in ("global", None):
        got, _ = cuda_wavefront.relax_field_cuda(enter, start, turn, form=form)
        assert torch.equal(got, ref)
        got, passes = cuda_sweep.relax_sweep_field_cuda(enter, start, turn, form=form)
        assert torch.equal(got, ref_sweep) and torch.equal(passes, ref_passes)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(640, 640), (1080, 1920), QHD_PORTRAIT, UHD])
def test_global_astar_form_bit_equal_on_card(cuda, hw):
    """The A* kernel's global form (forced, and the wrapper's own pick) gives
    the plain version's cells, lengths, costs, cache, pops and
    relaxations."""
    from vision_assist_tpu_torch.pipeline.planner import make_plan_step

    cfg = config.PipelineConfig(frame_height=hw[0], frame_width=hw[1])
    occ = torch.from_numpy(walkway(cfg.lattice_rows, cfg.lattice_cols)).to(cuda)
    pr = make_plan_step(cfg, include_paths=False)(occ)
    goals = wavefront.closest_walkable_cell(
        pr.walkable, torch.stack([pr.peaks.centre_x, pr.peaks.centre_y], -1),
        cfg.grid.grid_size)
    inp = (pr.walkable, pr.penalty, pr.start_rc, goals, pr.peaks.valid)
    kw = dict(grid_size=cfg.grid.grid_size, max_len=cfg.pathfinder.max_path_len)
    ref, cache, counts = device_astar.device_astar_paths_plain(
        *inp, device_astar.empty_cache(cuda), return_counts=True, **kw)
    for form in ("global", None):
        cells, lengths, costs, cache_k, stats = cuda_astar.astar_paths_cuda(
            *(x[None] for x in inp), device_astar.empty_cache(cuda)[None], form=form, **kw)
        assert torch.equal(cells[0], ref.cells) and torch.equal(lengths[0], ref.lengths)
        assert torch.equal(costs[0], ref.costs)
        assert torch.equal(cache_k[0].nan_to_num(-1.0), cache.nan_to_num(-1.0))
        assert stats[0].tolist() == [list(c) for c in counts]
