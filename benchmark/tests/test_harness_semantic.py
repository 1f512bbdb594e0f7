"""A configuration with a per-pixel class head (``"head": "semantic"``),
added as new files alone: its own reference module (here a toy with
SegFormer's blocks), a configuration that names it, seeded weights and
``walkable_classes``, and a limits file. Its model is judged at its logits
(``head_gap``), the chain after the model (every class's logit sampled at
the cell centres, the lattice) from the program's own logits (``conf_gap``,
``occ_share``, ``ndet_gap``), its planner as every configuration's.

The port serves no per-pixel model yet, so the program's place is taken by
a stand-in: the reference's own logits rounded to bf16, each step's frames
through the chain after the model. It serves float32 at imgsz 128. On this
CPU the stand-in reads ``head_gap`` 7.7e-3 and 0 on the chain's three
numbers; the logits scaled by 1.01 read ``head_gap`` 4.4e-2, the float8
control 0.38, and the bfloat16 chain control ``conf_gap`` 3.2e-4 and
``occ_share`` 3.5 %; the limit of ``head_gap`` is 0.02.

The weights seed is one under which class 1 wins some cells of each frame
and not all (23 to 36 % of them). Under 36 of 40 seeds tried it wins none
(35) or every one (1): the seeded classifier's biases and its logits'
constant parts (SD about 0.2) outweigh the logits' spread over a frame
(SD 0.04 to 0.09), so the classes whose offsets lie highest win everywhere.

And an instance head's configurations are untouched: the port's
``ModelConfig`` is the one its nine keys gave, and the seeded trees are the
ones drawn before the draw knew a Linear layer or a LayerNorm.
"""

import hashlib
import json
import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from conftest import CPU_SEED, ROOT, cpu_traffic, make_root

from benchmark.control import control_numbers
from benchmark.harness import weights
from benchmark.harness.cell import load_cell, reference_module
from benchmark.harness.check import (
    SEEDED_NUMBERS,
    check,
    reference_segmentation,
    served_segmentation,
)
from benchmark.harness.frames import make_pool, stream_offsets
from benchmark.harness.peaks import model_flops
from benchmark.harness.serve import Answer, model_config
from benchmark.harness.weights import flax_tree
from benchmark.reference.plan import ReferencePlanner
from benchmark.reference.segment import ReferenceSegmenter, SemanticChain

TOY_REFERENCE = '''"""A toy per-pixel segmenter with SegFormer's blocks: an overlapping
patch embedding (7x7 at stride 4, a LayerNorm), one pre-norm block of
efficient self-attention (a Linear query; keys and values from a stride-2
convolution and a LayerNorm; softmax attention; a Linear projection) and a
Mix-FFN (Linear, 3x3 depthwise convolution, GELU, Linear), then a 1x1
convolution with BatchNorm and ReLU and a 1x1 classifier, at stride 4."""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

WIDTH, HIDDEN, DECODER = 32, 128, 64


@dataclasses.dataclass
class Outputs:
    logits: torch.Tensor


class ToySeg(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        c = WIDTH
        self.patch = nn.Conv2d(3, c, 7, 4, 3)
        self.patch_norm = nn.LayerNorm(c)
        self.norm1 = nn.LayerNorm(c)
        self.q = nn.Linear(c, c)
        self.sr = nn.Conv2d(c, c, 2, 2)
        self.sr_norm = nn.LayerNorm(c)
        self.kv = nn.Linear(c, 2 * c)
        self.proj = nn.Linear(c, c)
        self.norm2 = nn.LayerNorm(c)
        self.fc1 = nn.Linear(c, HIDDEN)
        self.dw = nn.Conv2d(HIDDEN, HIDDEN, 3, 1, 1, groups=HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, c)
        self.fuse = nn.Conv2d(c, DECODER, 1, bias=False)
        self.bn = nn.BatchNorm2d(DECODER)
        self.cls = nn.Conv2d(DECODER, num_classes, 1)
        self.quant = None

    def _q(self, x):
        return x if self.quant is None else self.quant(x)

    def conv(self, m, x):
        return F.conv2d(self._q(x), self._q(m.weight), m.bias, m.stride, m.padding, 1,
                        m.groups)

    def dense(self, m, x):
        return F.linear(self._q(x), self._q(m.weight), m.bias)

    def forward(self, images):
        x = self.conv(self.patch, images)
        b, c, h, w = x.shape
        t = self.patch_norm(x.flatten(2).transpose(1, 2))
        y = self.norm1(t)
        q = self.dense(self.q, y)
        r = self.conv(self.sr, y.transpose(1, 2).reshape(b, c, h, w))
        k, v = self.dense(self.kv, self.sr_norm(r.flatten(2).transpose(1, 2))).chunk(2, -1)
        a = torch.softmax(self._q(q) @ self._q(k).transpose(1, 2) / c ** 0.5, dim=-1)
        t = t + self.dense(self.proj, self._q(a) @ self._q(v))
        y = self.dense(self.fc1, self.norm2(t)).transpose(1, 2).reshape(b, HIDDEN, h, w)
        t = t + self.dense(self.fc2, F.gelu(self.conv(self.dw, y)).flatten(2).transpose(1, 2))
        x = F.relu(self.bn(self.conv(self.fuse, t.transpose(1, 2).reshape(b, c, h, w))))
        return Outputs(self.conv(self.cls, x))


def build_model(config):
    return ToySeg(config["num_classes"])


def set_quant(model, quant):
    model.quant = quant


def flax_leaves(model):
    out = []
    for name, m in model.named_modules():
        p, s = ("params", name), ("batch_stats", name)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            layout = "conv" if isinstance(m, nn.Conv2d) else "dense"
            out.append((f"{name}.weight", p + ("kernel",), layout))
            if m.bias is not None:
                out.append((f"{name}.bias", p + ("bias",), "same"))
        elif isinstance(m, nn.LayerNorm):
            out += [(f"{name}.weight", p + ("scale",), "layer_norm"),
                    (f"{name}.bias", p + ("bias",), "same")]
        elif isinstance(m, nn.BatchNorm2d):
            out += [(f"{name}.weight", p + ("scale",), "same"),
                    (f"{name}.bias", p + ("bias",), "same"),
                    (f"{name}.running_mean", s + ("mean",), "same"),
                    (f"{name}.running_var", s + ("var",), "same")]
    return out


def load_flax_variables(model, variables):
    state = {}
    for key, path, layout in flax_leaves(model):
        value = np.asarray(variables[path[0]][path[1]][path[2]], np.float32)
        if layout == "conv":
            value = value.transpose(3, 2, 0, 1)
        elif layout == "dense":
            value = value.T
        state[key] = torch.from_numpy(np.ascontiguousarray(value))
    model.load_state_dict(state, strict=False)
'''

CELL = "toyseg.cpu"
SEED = 2 ** 31 + 22          # past 32 signed bits; class 1 wins 23-36 % of the cells
CONFIG = {"name": "toyseg-128", "arch": "toyseg", "head": "semantic", "reference": "toyseg",
          "imgsz": 128, "num_classes": 19, "walkable_classes": [1], "dtype": "float32",
          "weights": {"seed": SEED}, "grid_size": 20, "transfer_format": "i420"}
LIMITS = {"head_gap": 0.02, "conf_gap": 1e-5, "occ_share": 0.005, "ndet_gap": 0,
          "plan_frames": 0, "answer_frames": 0, "field_gap": 1e-5, "cost_gap": 1e-5,
          "state_gap": 0, "missing": 0}
HW = (1280, 720)
CPU = torch.device("cpu")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def tree_digest(tree) -> str:
    """One digest of a Flax tree: every leaf's path, dtype, shape and bytes."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            a = np.ascontiguousarray(node)
            h.update(repr((path, a.dtype.str, a.shape)).encode())
            h.update(a.tobytes())
    walk(tree, ())
    return h.hexdigest()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout to which only new files were added, with their digests
    before the additions."""
    root = make_root(tmp_path_factory.mktemp("semantic"))
    before = _digests(root)
    bench = root / "benchmark"
    (bench / "reference" / "toyseg.py").write_text(TOY_REFERENCE)
    (bench / "configs" / "toyseg-128.json").write_text(json.dumps(CONFIG))
    (bench / "traffic" / "tiny.batch2.json").write_text(json.dumps(cpu_traffic("batched")))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "toyseg-128", "source": "https://x.org",
                                "file": "benchmark/configs/toyseg-128.json",
                                "reduced": [], "why": "a per-pixel head"})
    manifest["workloads"].append({"name": CELL, "config": "toyseg-128",
                                  "traffic": "tiny.batch2", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root, before


@pytest.fixture(scope="module")
def toy(root):
    """(the checkout, the cell, its pool, the drawn tree, the reference
    segmenter on it)."""
    root, _ = root
    cell = load_cell(root, CELL)
    pool = make_pool(cell.traffic, CPU_SEED)
    tree = flax_tree(root, cell.config, CPU)
    ref = ReferenceSegmenter(cell.config, reference_module(root, cell.config), tree, HW, CPU)
    return root, cell, pool, tree, ref


def _iter_leaves(tree):
    for v in tree.values():
        yield from (_iter_leaves(v) if isinstance(v, dict) else [v])


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --- the seeded draw ----------------------------------------------------------


def test_the_draw_is_finite_and_its_logits_keep_their_size(toy):
    _, _, pool, tree, ref = toy
    leaves = [np.asarray(v) for v in _iter_leaves(tree)]
    assert all(np.isfinite(v).all() for v in leaves)
    with torch.no_grad():
        logits = ref.model(ref.images(pool)).logits
    assert logits.shape == (len(pool), 19, 32, 32)
    for frame in logits:
        rms = float(torch.sqrt(torch.mean(frame.double() ** 2)))
        assert 0.05 <= rms <= 20, rms


def test_the_same_seed_draws_the_same_tree(toy):
    root, cell, _, tree, _ = toy
    assert tree_digest(flax_tree(root, cell.config, CPU)) == tree_digest(tree)
    other = dict(cell.config, weights={"seed": SEED + 1})
    assert tree_digest(flax_tree(root, other, CPU)) != tree_digest(tree)


@pytest.mark.parametrize("layer, fan_in, fan_out", [("fc1", 32, 128), ("fc2", 128, 32),
                                                    ("kv", 32, 64)])
def test_a_dense_kernel_lies_in_flax_layout_with_the_sd_of_its_fan_in(toy, layer, fan_in,
                                                                      fan_out):
    kernel = _leaf(toy[3], ("params", layer, "kernel"))
    assert kernel.shape == (fan_in, fan_out)
    assert float(np.std(kernel)) == pytest.approx(1 / math.sqrt(fan_in), rel=0.06)


def test_a_layer_norms_scale_is_drawn_as_any_other_leaf_a_batch_norms_small(toy):
    tree = toy[3]
    for name in ("patch_norm", "norm1", "sr_norm", "norm2"):
        scale = _leaf(tree, ("params", name, "scale"))
        assert 0.5 <= scale.min() and scale.max() <= 1.5 and scale.max() > 1.2, name
    bn = _leaf(tree, ("params", "bn", "scale"))
    assert weights.SCALE[0] <= bn.min() and bn.max() <= weights.SCALE[1]
    assert _leaf(tree, ("batch_stats", "bn", "var")).min() > 0


def test_model_flops_count_the_attentions_matmuls(toy):
    root, cell, *_ = toy
    n, m, c, hid, dec, k = 32 * 32, 16 * 16, 32, 128, 64, 19
    macs = (n * c * 3 * 49            # the patch embedding
            + n * c * c               # q
            + m * c * c * 4           # the stride-2 reduction
            + m * c * 2 * c           # k and v
            + 2 * n * m * c           # q kᵀ and the probabilities times v
            + n * c * c               # the projection
            + n * c * hid + n * hid * 9 + n * hid * c    # the Mix-FFN
            + n * c * dec + n * dec * k)                  # the decoder and the classifier
    model = reference_module(root, cell.config).build_model(cell.config)
    assert model_flops(model, 128) == 2 * macs


# --- the chain after the model, on hand-made logits ---------------------------


def _chain(walkable=(1,)):
    return SemanticChain(dict(CONFIG, walkable_classes=list(walkable)), HW, CPU)


def _linear_logits(**slopes):
    """(2, 19, 32, 32) logits: class i is a + b * x at each logit's centre x
    in letterbox pixels, for ``c<i>=(a, b)``; -10 for a class not given.
    The bilinear sample of a linear map is the map at the sampled point."""
    x = (torch.arange(32, dtype=torch.float32) + 0.5) * 4 - 0.5
    logits = torch.full((2, 19, 32, 32), -10.0)
    for name, (a, b) in slopes.items():
        logits[:, int(name[1:])] = (a + b * x)[None, :]
    return logits


def _segment(chain, logits):
    return chain.segment(types.SimpleNamespace(logits=logits))


def test_class_1_winning_on_a_half_plane_occupies_those_cells():
    chain = _chain()
    segs = _segment(chain, _linear_logits(c0=(0.0, 0.0), c1=(64.0, -1.0)))
    want = (chain.centres[:, 0] < 64).numpy().reshape(chain.rows, chain.cols)
    assert 0 < want.sum() < want.size
    for s in segs:
        assert (s.occupancy == want).all()
        assert s.n_detections == 1 and s.n_candidates == 0 and s.top_score == s.best_conf
        z = torch.full((19,), -10.0)
        z[0], z[1] = 0.0, 64.0 - float(chain.centres[:, 0].min())
        assert s.best_conf == pytest.approx(float(torch.softmax(z, 0)[1]), rel=1e-6)


def test_class_0_everywhere_detects_nothing():
    segs = _segment(_chain(), _linear_logits(c0=(1.0, 0.0), c1=(0.0, 0.0)))
    for s in segs:
        assert not s.occupancy.any() and s.n_detections == 0 and s.best_conf == 0.0


def test_two_walkable_classes_occupy_their_union():
    logits = _linear_logits(c0=(0.0, 0.0), c1=(50.0, -1.0), c2=(-80.0, 1.0))
    chain = _chain((1, 2))
    x = chain.centres[:, 0].numpy().reshape(chain.rows, chain.cols)
    left, right = x < 50, x > 80
    assert left.any() and right.any() and not (left | right).all()
    assert all((s.occupancy == (left | right)).all() for s in _segment(chain, logits))
    assert all((s.occupancy == left).all() for s in _segment(_chain((1,)), logits))


@pytest.mark.parametrize("walkable, occupied", [((1,), True), ((2,), False)])
def test_a_tie_goes_to_the_first_class(walkable, occupied):
    segs = _segment(_chain(walkable), _linear_logits(c1=(5.0, 0.0), c2=(5.0, 0.0)))
    for s in segs:
        assert s.occupancy.all() if occupied else not s.occupancy.any()


@pytest.mark.parametrize("hw", [(32, 32), (16, 16), (40, 40)])
def test_the_sampled_logits_are_bilinear_grid_samples(hw):
    chain = _chain()
    logits = torch.randn((2, 19) + hw, generator=torch.Generator().manual_seed(7))
    mine = chain.sample(logits)
    # align_corners=False, the source coordinate clamped to the border
    grid = 2 * (chain.centres + 0.5) / CONFIG["imgsz"] - 1
    theirs = F.grid_sample(logits, grid[None, None].expand(2, 1, -1, -1), mode="bilinear",
                           padding_mode="border", align_corners=False)[:, :, 0]
    assert mine.shape == (2, 19, chain.rows * chain.cols)
    torch.testing.assert_close(mine, theirs, rtol=0, atol=1e-5)


# --- check.check with a stand-in program ---------------------------------------


class AlignCorners(SemanticChain):
    """The logits sampled with align_corners=True."""

    def sample(self, maps):
        grid = 2 * self.centres / (CONFIG["imgsz"] - 1) - 1
        return F.grid_sample(maps, grid[None, None].expand(len(maps), 1, -1, -1),
                             mode="bilinear", padding_mode="border", align_corners=True)[:, :, 0]


def judge(toy, chain=None, scale=1.0, alter=None):
    """``check.check`` of the answers a stand-in program gives: the
    reference's logits rounded to bf16 (times ``scale``) as each step
    serves them, through ``chain`` (the sound chain where None) and each
    stream's reference planner, ``alter`` given the answers last."""
    root, cell, pool, tree, ref = toy
    t = cell.traffic
    with torch.no_grad():
        logits = ref.model(ref.images(pool)).logits.to(torch.bfloat16).float() * scale
    offsets = stream_offsets(t)
    steps = [[(o + k) % len(pool) for o in offsets] for k in range(len(pool))]
    served = [(k, idx, types.SimpleNamespace(logits=logits[idx]))
              for k, idx in enumerate(steps)]
    chain = chain or SemanticChain(cell.config, HW, CPU)
    segs = [chain.segment(outs) for _, _, outs in served]
    answers = []
    for s in range(t["streams"]):
        planner = ReferencePlanner(HW, cell.config["grid_size"], t["engine"] == "exact_device")
        for k, idx in enumerate(steps):
            r, now = segs[k][s], k * t["frame_interval_ms"]
            p = planner.frame(r.occupancy, r.n_detections, now)
            answers.append(Answer(s, k, idx[s], now, r.occupancy.copy(), r.n_detections,
                                  r.best_conf, p.walkable, p.artificial, p.penalty, p.peaks,
                                  p.paths, p.answer))
    if alter is not None:
        alter(answers)
    correct, checks, seg = check(root, cell, pool, tree, answers, len(answers), CPU, None,
                                 served_segmentation(cell.config, HW, iter(served), CPU))
    return correct, {k: v for k, (v, _) in checks.items()}, seg


def test_a_sound_stand_in_is_correct(toy):
    correct, numbers, seg = judge(toy)
    assert correct, numbers
    assert list(numbers) == list(SEEDED_NUMBERS)
    assert 0 < numbers["head_gap"] <= LIMITS["head_gap"] / 2, numbers
    # the lattice has work: the walkable class wins some cells of every frame
    assert all(s.n_detections == 1 and 0 < s.occupancy.sum() < s.occupancy.size for s in seg)


def flip_a_cell(answers):
    answers[0].occupancy[10, 5] = ~answers[0].occupancy[10, 5]


def one_detection_more(answers):
    answers[0].n_detections += 1


@pytest.mark.parametrize("fault, numbers", [
    ({"chain": SemanticChain(dict(CONFIG, walkable_classes=[0]), HW, CPU)},
     ("occ_share", "ndet_gap")),
    ({"chain": AlignCorners(CONFIG, HW, CPU)}, ("occ_share",)),
    ({"alter": flip_a_cell}, ("occ_share",)),
    ({"alter": one_detection_more}, ("ndet_gap",)),
    ({"scale": 1.01}, ("head_gap",)),
], ids=["road_for_sidewalk", "align_corners", "one_cell_flipped", "n_detections",
        "logits_x1.01"])
def test_a_fault_of_the_program_is_not_correct(toy, fault, numbers):
    correct, read, _ = judge(toy, **fault)
    assert not correct, read
    assert any(read[k] > LIMITS[k] for k in numbers), read


def test_the_float8_control_fails_head_gap_and_the_bf16_chain_the_lattice(toy):
    root, cell, _, tree, _ = toy
    control = control_numbers(root, cell, CPU_SEED, CPU, tree)
    assert control["head_gap"] > 10 * LIMITS["head_gap"], control
    # the bfloat16 chain after the model
    assert control["conf_gap"] > 10 * LIMITS["conf_gap"], control
    assert control["occ_share"] > 10 * LIMITS["occ_share"], control
    assert control["detected_share"] == 1.0


def test_the_checkout_gained_new_files_alone(root, toy):
    root, before = root
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_the_reference_path_gives_each_frame_its_flat_logits(toy):
    """The reference path alone, heads included, as the check calls it."""
    root, cell, pool, tree, _ = toy
    seg = reference_segmentation(root, cell.config, tree, pool, CPU, heads=True)
    assert len(seg) == len(pool)
    assert all(len(s.heads) == 1 and s.heads[0].shape == (19 * 32 * 32,) for s in seg)


# --- the instance head is untouched ------------------------------------------


INSTANCE = ["yolo11n-seg-256", "yolov8n-seg-640", "yolo12x-seg-640", "yolov9e-seg-640"]


@pytest.mark.parametrize("name", INSTANCE)
def test_an_instance_configuration_gets_the_model_config_of_its_nine_keys(name):
    from vision_assist_tpu_torch.config import ModelConfig

    c = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    nine = ModelConfig(
        arch=c["arch"], num_classes=c["num_classes"], imgsz=c["imgsz"],
        conf_threshold=c["conf_threshold"], iou_threshold=c["iou_threshold"],
        max_detections=c["max_detections"], reg_max=c["reg_max"],
        num_mask_coeffs=c["num_mask_coeffs"], dtype=c["dtype"])
    assert model_config(c) == nine


# The digests the draw gave before it knew a Linear layer or a LayerNorm, of
# each seeded configuration's tree at its own widths and seed, calibrated at
# imgsz 64 (its leaves other than the running statistics do not depend on
# the size), on the CPU with one thread.
SEEDED_DIGESTS = {
    "yolo12x-seg-640": "a92e2542cf64fb254d60dd8d064c4359a410a53b78912dade94653e52a122ce7",
    "yolov9e-seg-640": "33a523de079b7deb04d0b16ed1093cc6bbe2a1f4421a0bda1e4d95e8908b65ef",
}


@pytest.mark.parametrize("name", sorted(SEEDED_DIGESTS))
def test_a_seeded_instance_tree_is_drawn_as_before(name):
    c = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tree = flax_tree(ROOT, dict(c, imgsz=64), CPU)
    finally:
        torch.set_num_threads(threads)
    assert tree_digest(tree) == SEEDED_DIGESTS[name]
