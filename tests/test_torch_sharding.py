"""The port's sharding rules (`repro_torch.distributed.sharding`) against
`repro.distributed.sharding`, and the mesh constructors, in one process.

`spec_for` must give the reference's PartitionSpec entries exactly over a
sweep of logical dims and shapes (every parameter of every architecture at
full and smoke size, and the activations the model constrains, at batch
sizes and lengths that divide the axes and that do not) x the three
strategies x activation or not, on meshes of 1x1, 2x2, 16x16 and 2x16x16
(the multi-pod one with the batch over (pod, data), as `production_ctx`
builds it).  Both sides read only the mesh's axis sizes, so both run
against a stand-in with a `.shape` mapping.  `placements_for` turns a spec
into one DTensor placement per mesh dim; it refuses what the reference's
NamedSharding refuses (an axis twice, an uneven shard).  Without a card,
or over a process group of another backend, `make_mesh(device="cuda")`
raises and never falls back to gloo; the production meshes raise without
their world size.  The serve launcher drains its requests on the CPU.
"""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import itertools

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.distributed import sharding as jsharding
from repro.models.model import param_shapes as jparam_shapes
from repro_torch.configs import list_archs
from repro_torch.distributed import compat, sharding
from repro_torch.launch import mesh as launch_mesh


class StandIn:
    """A mesh as the rules read it: `.shape`, axis name -> size."""

    def __init__(self, shape):
        self.shape = dict(shape)


class NamedStandIn:
    """A mesh as `placements_for` reads it: named dims and their sizes."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


MESHES = {
    "1x1": ({"data": 1, "model": 1}, ("data",)),
    "2x2": ({"data": 2, "model": 2}, ("data",)),
    "16x16": ({"data": 16, "model": 16}, ("data",)),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
}
STRATEGIES = ("tp", "fsdp", "fsdp_ep")

ACTIVATIONS = [("batch", None), ("batch", None, None), ("batch", None, "ff"),
               ("batch", None, "vocab"), ("batch", None, "heads", None),
               ("batch", None, "kv", None), ("batch", "seq_tp", None, None),
               ("batch", None, None, None), (None, "batch"), ("experts", None, "fsdp"),
               ("experts", "fsdp", None), ("batch", None, "inner"), ("batch", "state_tp"),
               ("batch", "seq", "moe_ff"), ("d", "hd_out")]
BATCHES = (1, 2, 3, 4, 8, 12, 16, 32, 48, 512, 1024)
OTHER = (1, 24, 64, 96, 4096, 151552)


def _param_cases():
    """(dims, shape) of every parameter of every architecture, full size and
    smoke, from the reference's own `param_shapes`."""
    out = set()
    for arch in list_archs():
        for cfg in (jget_config(arch), jget_smoke(arch)):
            shapes, dims = jparam_shapes(cfg)
            segs = list(zip(shapes.pop("segments"), dims.pop("segments")))
            pairs = [(dims[k], shapes[k]) for k in shapes]
            pairs += [(sd[k], ss[k]) for ss, sd in segs for k in ss]
            out.update((tuple(d), tuple(s)) for d, s in pairs)
    return sorted(out, key=repr)


def _activation_cases():
    out = []
    for dims in ACTIVATIONS:
        for b in BATCHES:
            for rest in itertools.product(OTHER[:3] + OTHER[4:], repeat=len(dims) - 1):
                out.append((dims, (b,) + rest))
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_equals_the_reference(mesh, strategy):
    shape, dp_axes = MESHES[mesh]
    ref = jsharding.ShardingCtx(mesh=StandIn(shape), dp_axes=dp_axes, strategy=strategy)
    port = sharding.ShardingCtx(mesh=StandIn(shape), dp_axes=dp_axes, strategy=strategy)
    assert (port.dp, port.tp) == (ref.dp, ref.tp)
    cases = _param_cases() + _activation_cases()
    n = 0
    for dims, shp in cases:
        for activation in (False, True):
            for s in (shp, None):
                want = tuple(jsharding.spec_for(dims, ref, s, activation))
                assert sharding.spec_for(dims, port, s, activation) == want, (dims, s, activation)
                n += 1
    assert n > 10_000


def test_spec_for_without_a_mesh_is_empty():
    for dims in ACTIVATIONS:
        assert sharding.spec_for(dims, sharding.local_ctx()) == () == tuple(
            jsharding.spec_for(dims, jsharding.local_ctx()))
    assert sharding.sharding_for(("batch",), sharding.local_ctx()) is None


def test_placements_shard_each_named_axis():
    m = NamedStandIn({"pod": 2, "data": 4, "model": 8})
    assert sharding.placements_for((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements_for((None, None), m) == (Replicate(),) * 3
    assert sharding.placements_for(("data", ("model",)), m, (4, 16)) == (
        Replicate(), Shard(0), Shard(1))
    ctx = sharding.ShardingCtx(mesh=m, dp_axes=("pod", "data"), strategy="fsdp")
    assert sharding.sharding_for(("batch", None, "ff"), ctx, (64, 3, 8), activation=True) == (
        Shard(0), Shard(0), Shard(0))


def test_placements_refuse_what_the_reference_refuses():
    m = NamedStandIn({"data": 2, "model": 2})
    # decode under fsdp: the wide batch and seq_tp both on `model`
    ctx = sharding.ShardingCtx(mesh=StandIn({"data": 2, "model": 2}), strategy="fsdp")
    spec = sharding.spec_for(("batch", "seq_tp", None, None), ctx, (4, 96, 2, 16),
                             activation=True)
    assert spec == (("data", "model"), "model", None, None)
    with pytest.raises(sharding.DuplicateSpecError, match="'model'"):
        sharding.placements_for(spec, m)
    with pytest.raises(ValueError, match="not in the mesh's order"):
        sharding.placements_for((("model", "data"),), m)
    with pytest.raises(ValueError, match="does not divide into 4 shards"):
        sharding.placements_for((("data", "model"), None), m, (6, 3))


def test_make_mesh_on_the_card_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        compat.make_mesh((1, 1), ("data", "model"), device="cuda")
    with pytest.raises(ValueError, match="not one of"):
        compat.make_mesh((1, 1), ("data", "model"), device="tpu")


@pytest.fixture
def one_rank():
    """A gloo process group of one rank in this process, torn down after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_over_gloo_only_for_the_cpu(one_rank, monkeypatch):
    mesh = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with compat.use_mesh(mesh) as m:
        assert m is mesh
    ctx = sharding.ShardingCtx(mesh=mesh)
    assert (ctx.dp, ctx.tp, ctx.axis_size(("data", "model"))) == (1, 1, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="needs a nccl process group, not gloo"):
        compat.make_mesh((1, 1), ("data", "model"), device="cuda")
    with pytest.raises(RuntimeError, match=r"mesh \(2, 2\) needs 4 ranks"):
        compat.make_mesh((2, 2), ("data", "model"), device="cpu")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_world_size(one_rank, multi_pod):
    n = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"needs {n} ranks, found 1"):
        launch_mesh.production_ctx(multi_pod=multi_pod, device="cpu")


def test_hardware_constants_are_the_h100s():
    assert launch_mesh.PEAK_FLOPS_BF16 == 989e12 and launch_mesh.HBM_BW == 3.35e12


def test_serve_launcher_drains_its_requests(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --smoke --device cpu`: the
    reference's request stream (prompts of 8 + i % 24 ids), every request
    drained with --max-new tokens; without a card `--device cuda` raises."""
    from repro_torch.launch import serve

    got = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--requests", "6",
                      "--max-new", "5"])
    assert got["requests"] == 6 and got["tokens"] == 30 and got["ticks"] == 8
    assert "[serve] 6 requests, 30 tokens" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke"])
