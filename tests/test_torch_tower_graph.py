"""The towers' CUDA-graph replay in evaluation
(``clipspm_tpu_torch/models/tower_graph.py``).

On the CPU every call runs the eager body, counted under its reason (the
input on the CPU, grad mode, a module in train mode, a tensor-parallel
context, a hook inside the tower), with outputs those of ``tower_forward``;
the ``model.tower`` span says ``graph="eager"``; the tower key follows the
parameters' and buffers' addresses and the switches, and a copy of a tower
starts without graphs.

The ``cuda`` cases run on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_tower_graph.py``; this file imports no JAX): replay against
eager for the ViT (test-tiny), the ModifiedResNet (test-tiny-rn) and a
torchvision trunk under bf16 autocast; eight replays in a row each giving
its own chunk; an in-place weight update and ``load_state_dict`` followed,
an assigning load captured again; ``Learner.evaluate`` from a cold start
with its staging thread live during capture against the same call run
eager; ``INT8_EVAL`` against its eager self, its GEMMs counted; a
profiler trace linking a replay's kernels to a host op inside the tower's
call, as it does the eager body's.
"""

import copy
import dataclasses
import pickle
import types

import pytest
import torch
from torch.autograd import DeviceType

from clipspm_tpu_torch.data.synthetic import SyntheticEpisodeSource
from clipspm_tpu_torch.data.transforms import TransformSpec
from clipspm_tpu_torch.models import tower_graph
from clipspm_tpu_torch.models.backbones.clip import (CLIP_ARCHS,
                                                     make_clip_visual)
from clipspm_tpu_torch.models.backbones.resnet import TorchResNet
from clipspm_tpu_torch.models.fsar import build_model
from clipspm_tpu_torch.models.visual import encode_chunked
from clipspm_tpu_torch.ops import quant
from clipspm_tpu_torch.train.learner import Learner
from clipspm_tpu_torch.utils.config import SPM_DEFAULT_PARAMS, ConfigNode
from clipspm_tpu_torch.utils.metrics import recording
from clipspm_tpu_torch.weights import random_init_

PX = 32


def _tower(kind: str, int8: bool = False) -> torch.nn.Module:
    """A small tower of each class that ``encode_chunked`` is handed, with
    seeded weights, in eval mode."""
    if kind == "vit":
        arch = CLIP_ARCHS["test-tiny"]
        if int8:
            arch = dataclasses.replace(arch, int8_eval=True)
        tower = make_clip_visual(arch)
    elif kind == "rn":
        tower = make_clip_visual(CLIP_ARCHS["test-tiny-rn"])
    else:
        tower = TorchResNet(arch="resnet18", output="spatial", width=8)
    return random_init_(tower, torch.Generator().manual_seed(5)).eval()


def _frames(n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n, PX, PX, 3, generator=gen).to(device)


def _delta(before: dict) -> dict:
    now = tower_graph.counts()
    out = {k: now[k] - before[k] for k in ("replay", "capture", "eager")}
    out.update({k: v - before["eager_reasons"][k]
                for k, v in now["eager_reasons"].items()
                if v != before["eager_reasons"][k]})
    return out


# -- the CPU: every call eager, with its reason -------------------------------

@pytest.mark.parametrize("kind", ["vit", "rn", "torchvision"])
def test_cpu_calls_run_the_eager_body(kind):
    tower = _tower(kind)
    x = _frames(3)
    with torch.no_grad():
        want = tower.tower_forward(x)
        before = tower_graph.counts()
        got = [tower(x) for _ in range(3)]
    assert all(torch.equal(g, want) for g in got)
    assert _delta(before) == {"replay": 0, "capture": 0, "eager": 3,
                              "cpu": 3}
    assert tower_graph.last_mode() == "eager"
    assert "_tower_graphs" not in tower.__dict__


def _tp_stub(tower):
    """A tensor-parallel context of one rank on the first attention."""
    stub = types.SimpleNamespace(rank=0, world=1, copy_to=lambda v: v,
                                 reduce_from=lambda v: v)
    tower.transformer.resblocks[0].attn.tp = stub


def _inner_hook(tower):
    tower.ln_pre.register_forward_hook(lambda *args: None)


@pytest.mark.parametrize("reason,setup,grad", [
    ("grad", None, True),
    ("train", lambda t: t.transformer.resblocks[1].train(), False),
    ("tp", _tp_stub, False),
    ("hook", _inner_hook, False),
])
def test_each_reason_runs_eager_and_is_counted(reason, setup, grad):
    tower = _tower("vit")
    x = _frames(2, seed=1)
    with torch.no_grad():
        want = tower.tower_forward(x)
    if setup is not None:
        setup(tower)
    before = tower_graph.counts()
    with torch.set_grad_enabled(grad):
        got = tower(x)
    assert torch.equal(got.detach(), want)
    assert _delta(before) == {"replay": 0, "capture": 0, "eager": 1,
                              reason: 1}


def test_tower_span_says_eager():
    tower = _tower("vit")
    with recording() as records, torch.no_grad():
        feats = encode_chunked(tower, _frames(5, seed=2), chunk=2)
    towers = [r for r in records if r.name == "model.tower"]
    assert [r.attrs for r in towers] == [
        {"frames": 2, "graph": "eager"}, {"frames": 2, "graph": "eager"},
        {"frames": 1, "graph": "eager"}]
    assert feats.shape == (5, CLIP_ARCHS["test-tiny"].embed_dim)


def test_tower_key_follows_the_tensors_and_switches():
    tower = _tower("vit")
    reason, key = tower_graph.tower_key(tower)
    assert reason is None
    # in place: the graph reads the new values where they lie
    with torch.no_grad():
        tower.conv1.weight.add_(1.0)
    tower.load_state_dict(copy.deepcopy(tower.state_dict()))
    assert tower_graph.tower_key(tower) == (None, key)
    # a replaced parameter, an assigning load, a cast: new addresses
    tower.conv1.weight = torch.nn.Parameter(tower.conv1.weight.detach()
                                            .clone())
    _, replaced = tower_graph.tower_key(tower)
    assert replaced != key
    tower.load_state_dict(copy.deepcopy(tower.state_dict()), assign=True)
    _, assigned = tower_graph.tower_key(tower)
    assert assigned not in (key, replaced)
    assert tower_graph.tower_key(tower.double())[1] != assigned
    # a switch its blocks read while they run
    _, now = tower_graph.tower_key(tower)
    tower.transformer.resblocks[0].int8_eval = True
    assert tower_graph.tower_key(tower)[1] != now


@pytest.mark.parametrize("make", [
    lambda: make_clip_visual(dataclasses.replace(
        CLIP_ARCHS["test-tiny"], int8_eval=True, fast_softmax=True,
        bf16_norms=True)),
    lambda: make_clip_visual(CLIP_ARCHS["test-tiny-rn"]),
    lambda: TorchResNet(arch="resnet18", output="pooled", width=8),
    lambda: TorchResNet(arch="resnet50", output="spatial", width=8,
                        temporal_blocks="bottleneck", seq_len=4),
    lambda: TorchResNet(arch="resnet50", output="spatial", width=8,
                        temporal_blocks="stage", seq_len=4),
], ids=["vit", "rn", "torchvision", "temporal-bottleneck", "temporal-stage"])
def test_every_bool_switch_of_a_tower_is_in_its_key(make):
    """A plain bool a module of the tower holds may be read by its forward
    as it runs, so the tower class declares it in ``graph_switches`` and a
    flip of it changes the tower key."""
    tower = make().eval()
    found = {(type(m).__name__, k) for m in tower.modules()
             for k, v in m.__dict__.items()
             if isinstance(v, bool) and k != "training"}
    assert found
    undeclared = {f for f in found if f[1] not in type(tower).graph_switches}
    assert not undeclared
    for module in tower.modules():
        for k, v in list(module.__dict__.items()):
            if isinstance(v, bool) and k != "training":
                _, key = tower_graph.tower_key(tower)
                setattr(module, k, not v)
                assert tower_graph.tower_key(tower)[1] != key, k
                setattr(module, k, v)
                break


def test_a_copy_starts_without_graphs_and_the_state_dict_is_unchanged():
    tower = _tower("rn")
    names = list(tower.state_dict())
    tower._tower_graphs = tower_graph._Graphs()
    tower._tower_graphs.seen.add(("a key",))
    for other in (copy.deepcopy(tower), pickle.loads(pickle.dumps(tower))):
        assert other._tower_graphs is not tower._tower_graphs
        assert not other._tower_graphs.seen
    assert list(tower.state_dict()) == names


# -- the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU route")
    return torch.device("cuda")


def _autocast():
    return torch.autocast("cuda", dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vit", "rn", "torchvision"])
def test_replay_equals_eager_on_gpu(cuda_device, kind):
    tower = _tower(kind).to(cuda_device)
    xs = [_frames(6, seed=s, device=cuda_device) for s in range(4)]
    with torch.no_grad(), _autocast():
        want = [tower.tower_forward(x) for x in xs]
        before = tower_graph.counts()
        got = [tower(x) for x in xs]
    assert _delta(before) == {"replay": 2, "capture": 1, "eager": 1,
                              "first": 1}
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.stride() == w.stride()
        assert torch.equal(g, w), (g.float() - w.float()).abs().max().item()


@pytest.mark.cuda
def test_eight_replays_give_eight_chunks_on_gpu(cuda_device):
    tower = _tower("vit").to(cuda_device)
    x = _frames(8 * 4, seed=3, device=cuda_device)
    with torch.no_grad(), _autocast():
        encode_chunked(tower, x[:8], chunk=4)        # eager, then capture
        before = tower_graph.counts()
        got = encode_chunked(tower, x, chunk=4)
        want = [tower.tower_forward(x[i:i + 4]) for i in range(0, 32, 4)]
    assert _delta(before)["replay"] == 8
    chunks = got.split(4)
    assert all(torch.equal(g, w) for g, w in zip(chunks, want))
    assert all(not torch.equal(chunks[i], chunks[j])
               for i in range(8) for j in range(i))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_weights_updated_in_place_or_loaded_are_followed_on_gpu(
        cuda_device, kind):
    tower = _tower(kind).to(cuda_device)
    x = _frames(4, seed=4, device=cuda_device)

    def both():
        with torch.no_grad(), _autocast():
            return tower(x), tower.tower_forward(x)

    both(), both()                                   # eager, capture
    with torch.no_grad():
        for p in tower.parameters():                 # as Adam updates
            p.mul_(0.9).add_(0.01)
        for b in tower.buffers():                    # BatchNorm's stats
            if b.is_floating_point():
                b.mul_(1.1)
    before = tower_graph.counts()
    got, want = both()
    assert torch.equal(got, want) and _delta(before)["replay"] == 1
    other = random_init_(copy.deepcopy(tower).cpu(),
                         torch.Generator().manual_seed(9))
    tower.load_state_dict(other.state_dict())        # copies in place
    before = tower_graph.counts()
    got, want = both()
    assert torch.equal(got, want) and _delta(before)["replay"] == 1
    tower.load_state_dict({k: v.to(cuda_device) for k, v in
                           other.state_dict().items()}, assign=True)
    before = tower_graph.counts()
    for _ in range(3):
        got, want = both()
        assert torch.equal(got, want)
    assert _delta(before) == {"replay": 1, "capture": 1, "eager": 1,
                              "first": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_a_profiler_links_the_replays_kernels_to_the_replay_op_on_gpu(
        cuda_device, kind):
    """Each kernel a replay runs is linked in a ``torch.profiler`` trace to
    a host op that starts inside the tower's module call, on its thread, as
    the eager body's kernels are: the graph's to ``clipspm_tower_graph::
    replay``, the input's copy and the output's clone to their own ops."""
    from torch.profiler import ProfilerActivity, profile

    tower = _tower(kind).to(cuda_device)
    x = _frames(4, seed=8, device=cuda_device)
    with torch.no_grad(), _autocast():
        tower(x), tower(x)                           # eager, capture
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("eager"):
                tower.tower_forward(x)
            with torch.profiler.record_function("replay"):
                tower(x)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    ops = {e.correlation_id(): e for e in cpu if e.correlation_id() > 0}
    ranges = {e.name(): e for e in cpu if e.name() in ("eager", "replay")}

    def linked(name):
        lo = ranges[name].start_ns()
        hi = lo + ranges[name].duration_ns()
        kernels = [e for e in events if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation()
                   and e.start_ns() >= lo]
        out = []
        for k in kernels:
            op = ops.get(k.linked_correlation_id())
            if op is not None and lo <= op.start_ns() <= hi:
                out.append((op.name(), k.name()))
        return out

    eager, replay = linked("eager"), linked("replay")
    graph_kernels = [k for op, k in replay
                     if op == "clipspm_tower_graph::replay"]
    assert eager and len(graph_kernels) >= len(eager) // 2, (
        len(eager), replay[:20])
    assert {op for op, _ in replay} <= {"clipspm_tower_graph::replay",
                                        "aten::copy_", "aten::clone"}


@pytest.mark.cuda
def test_int8_eval_replay_equals_its_eager_self_on_gpu(cuda_device):
    tower = _tower("vit", int8=True).to(cuda_device)
    x = _frames(3, seed=6, device=cuda_device)
    blocks = len(tower.transformer.resblocks)
    with torch.no_grad(), _autocast():
        want = tower.tower_forward(x)
        launches = quant.launches
        got = [tower(x) for _ in range(4)]
    # every call ran its 4 projections a block through the int8 GEMM
    assert quant.launches - launches == 4 * 4 * blocks
    assert all(torch.equal(g, want) for g in got)


def _learner(device, chunk: int) -> Learner:
    cfg = ConfigNode({
        "MODEL": {"NAME": "clipspm", "BACKBONE": "test-tiny", "SEED": 0,
                  "ENCODE_CHUNK": chunk},
        "TRAIN": {"WAY": 2, "SHOT": 1, "QUERY_PER_CLASS": 1,
                  "TASKS_PER_BATCH": 2, "TRAIN_EPISODES": 4, "VAL_FREQ": 100,
                  "PRINT_FREQ": 2},
        "TEST": {"QUERY_PER_CLASS": 1, "TEST_EPISODES": 8},
        "DATA": {"DATASET": "generic", "IMG_SIZE": PX, "SEQ_LEN": 3},
        "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": "adam",
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9},
        "USE_AMP": True,
        "params": SPM_DEFAULT_PARAMS["hmdb"],
    })
    model = random_init_(build_model(cfg), torch.Generator().manual_seed(2))
    text = torch.randn(4, model.arch.embed_dim,
                       generator=torch.Generator().manual_seed(3))
    return Learner(cfg, model, text, text, device,
                   transform=TransformSpec(img_size=PX, resize_to=40),
                   log_fn=lambda *_: None)


@pytest.mark.cuda
def test_evaluate_from_a_cold_start_equals_eager_on_gpu(cuda_device):
    """Eight episodes in steps of four, 12 frames an episode through the
    tower 2 at a time: the first call eager, the second captured while the
    staging thread stacks and copies the next step; against the same call
    on a twin learner whose tower a hook keeps eager."""

    def run(eager: bool):
        learner = _learner(cuda_device, chunk=2)
        if eager:
            learner.model.backbone.ln_pre.register_forward_hook(
                lambda *args: None)
        src = SyntheticEpisodeSource(way=2, shot=1, queries=1, seq_len=3,
                                     img_size=40, num_classes=4, seed=7)
        before = tower_graph.counts()
        res = learner.evaluate(8, source=iter(src.sample, None),
                               batch_size=4)
        return res, _delta(before)

    want, eager = run(eager=True)
    got, graphed = run(eager=False)
    assert eager == {"replay": 0, "capture": 0, "eager": 48, "hook": 48}
    assert graphed == {"replay": 46, "capture": 1, "eager": 1, "first": 1}
    assert (got["loss_acc"] == want["loss_acc"]).all(), (
        got["loss_acc"], want["loss_acc"])
