"""Multi-pod dry run: trace every (architecture x input shape) cell's step
on the production meshes, in one process, with nothing computed.

Port of `repro/launch/dryrun.py`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --json out.json

Where the reference lowers and compiles on 512 placeholder host devices,
this runs the port's own step once as rank 0 of the production mesh:
  - the mesh: `fake_ctx` builds the (16, 16) or (2, 16, 16) `DeviceMesh`
    over torch's `fake` process group (`FakeStore`, world 256 or 512, rank
    0; its collectives move nothing).  It is the dry run's own entry:
    `distributed.compat.make_mesh` takes only NCCL and gloo, and the fake
    group is global to its process, so run the dry run in a process of its
    own (never one that holds another process group);
  - the tensors: the specs of `launch/specs.py`, fake tensors (DTensors
    under the mesh) in one `FakeTensorMode`, so the step allocates and
    computes nothing, and every kernel call routes to its plain version
    (`kernels/ops.py` routes a CPU tensor so; a dry run launches no
    kernel);
  - the step: `make_train_step` with the reference's optimizer choice
    (Adafactor above 5e10 parameters, else AdamW; bf16 moments), `prefill`,
    or `decode_step` at the cache's last position (S - 1) on the caches of
    `specs.cache_specs_from_eval`.

Per cell the record keeps the reference's keys.  What it counts is rank
0's own share, as the reference's per-device numbers are:
  - `flops`: 2 M N K of every matrix product (`mm`, `addmm`, `bmm`,
    `baddbmm`) at rank 0's local shapes, backward and recomputation
    included (the reference counts the HLO's dots, trip-aware).  A
    dispatch mode (`LocalCounter`) sees each product on DTensors and counts
    it from rank 0's shard of its result and of its contraction; a product
    on plain tensors (a local body's) from its operands.  `FlopCounterMode`
    would count each DTensor op at its global shape instead;
  - `dot_bytes`: each product's output and first operand, as the
    reference's;
  - `collectives` and `collective_bytes`: the functional collectives that
    DTensor issues on rank 0 and the process-group collectives of the
    port's own bodies (`distributed/collectives.py`, flash-decode's softmax
    statistics), by the reference's kind names, each its output's bytes
    times the reference's ring factor (all-reduce 2x, the rest 1x;
    `benchmarks/hlo_analysis.py`);
  - `memory.argument_bytes` and `memory.output_bytes`: rank 0's local
    bytes of the step's inputs and outputs (the decode's position counts 4
    bytes, an int32 scalar as the reference's argument is, though the
    port's step takes it as a host int; not for an SSM, whose step does not
    read it and whose jitted step the reference's `jax.jit` drops it from).

Keys with no torch counterpart hold None: `compile_s` (nothing is
compiled), `xla_flops_raw` and `xla_bytes_raw` (XLA's `cost_analysis`),
and `memory.temp_bytes` and `memory.peak_bytes` (XLA's buffer assignment of
the compiled program).  `lower_s` is the trace's seconds.  A failure to
trace (a sharding mismatch, an op DTensor cannot place) is a bug in the
port: the command exits 1 when any cell fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from collections import defaultdict
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch import specs as S
from repro_torch.models.model import decode_step, prefill
from repro_torch.train.optimizer import OptConfig, init_opt_state, tree_leaves

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default}
_funcol = torch.ops._c10d_functional
# the reference's kind names and ring factors (benchmarks/hlo_analysis.py)
_COLLECTIVES = {
    _funcol.all_gather_into_tensor.default: ("all-gather", 1.0),
    _funcol.all_reduce.default: ("all-reduce", 2.0),
    _funcol.reduce_scatter_tensor.default: ("reduce-scatter", 1.0),
    _funcol.all_to_all_single.default: ("all-to-all", 1.0),
}
_c10d = torch.ops.c10d
# the same for the process-group collectives, which write their output in
# place: their first argument (a list of tensors for the all-reduce)
_INPLACE = {
    _c10d.allreduce_.default: ("all-reduce", 2.0),
    _c10d._allgather_base_.default: ("all-gather", 1.0),
    _c10d._reduce_scatter_base_.default: ("reduce-scatter", 1.0),
    _c10d.alltoall_base_.default: ("all-to-all", 1.0),
}


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, MESHES[multi_pod][0]))


def fake_ctx(multi_pod: bool = False, strategy: str = "tp") -> ShardingCtx:
    """The production mesh as rank 0 of torch's `fake` process group (a
    world of 256, or 512 multi-pod), which this process must hold alone: a
    fake group of the other size is replaced, a group of another backend
    raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = MESHES[multi_pod]
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the dry run needs a process of its own: this one holds a "
                               f"{dist.get_backend()} process group")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    return ShardingCtx(mesh=mesh, dp_axes=dp_axes, strategy=strategy)


def local_bytes(tree) -> int:
    """Rank 0's bytes of every tensor in a tree (dicts, lists, tuples)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def _operands(func, args):
    """A matrix product's (lhs, rhs): `addmm` and `baddbmm` take the addend
    first."""
    return (args[0], args[1]) if func in (_aten.mm.default, _aten.bmm.default) \
        else (args[1], args[2])


class LocalCounter(S.DTensorOnFakes):
    """Counts rank 0's matrix-product FLOPs and collectives.

    A product on DTensors is counted from its result: rank 0's output shard
    times the contraction's length on rank 0: the whole length over the
    sizes of the mesh dims that shard it, those on which the result is
    `Partial` and no operand is (a `Partial` operand passes its own through
    a product).  A product on plain tensors outside any DTensor
    op (a local body's, or no mesh) is counted from its operands.  The
    products DTensor runs inside an op are not counted again (nor are they
    all seen: for placements that it has cached DTensor runs them below
    this mode).  The collectives it issues, and those of the port's own
    bodies, are counted where they run."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_bytes = 0.0
        self.collective_bytes = 0.0
        self.collectives = defaultdict(float)

    def _product(self, out: torch.Tensor, k: float) -> None:
        n = out.shape[-1]
        self.flops += 2.0 * out.numel() * k
        self.dot_bytes += out.element_size() * (out.numel() + out.numel() // n * k)

    def on_dtensor(self, func, args, out):
        if func in _MATMULS and self.depth == 0:
            a, b = _operands(func, args)
            k = a.shape[-1]
            for i, p in enumerate(out.placements):
                if p.is_partial() and not any(
                        isinstance(x, DTensor) and x.placements[i].is_partial() for x in (a, b)):
                    k //= out.device_mesh.size(i)
            self._product(out.to_local(), k)
        return out

    def local(self, func, args, kwargs):
        out = func(*args, **kwargs)
        if func in _MATMULS and self.depth == 0:
            self._product(out, _operands(func, args)[0].shape[-1])
        elif func in _COLLECTIVES:
            self._collective(_COLLECTIVES[func], [out])
        elif func in _INPLACE:
            self._collective(_INPLACE[func], args[0] if isinstance(args[0], list) else [args[0]])
        return out

    def _collective(self, kind_factor, outs) -> None:
        kind, factor = kind_factor
        nb = sum(t.numel() * t.element_size() for t in outs) * factor
        self.collective_bytes += nb
        self.collectives[kind] += nb


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: Optional[int] = None, strategy: str = "tp",
               remat_policy: Optional[str] = None):
    cfg = get_config(arch)
    if microbatches:
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    if remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    ok, why = S.cell_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": why}

    if strategy == "auto":
        strategy = "fsdp_ep" if cfg.moe_experts else "fsdp"
    ctx = fake_ctx(multi_pod=multi_pod, strategy=strategy)
    info = S.SHAPES[shape_name]
    counter = LocalCounter()
    with S.faking():
        pspecs = S.param_specs(cfg, ctx)
        t0 = time.time()
        if info["kind"] == "train":
            from repro_torch.train.loop import make_train_step

            batch = S.batch_specs(cfg, shape_name, ctx)
            optcfg = OptConfig(
                name="adafactor" if cfg.n_params() > 5e10 else "adamw",
                moments_dtype="bfloat16",
            )
            opt_state = init_opt_state(pspecs, optcfg)
            step = make_train_step(cfg, optcfg, ctx)
            arg_bytes = local_bytes((pspecs, opt_state, batch))
            with counter:
                out = step(pspecs, opt_state, batch)
        elif info["kind"] == "prefill":
            batch = S.batch_specs(cfg, shape_name, ctx)
            arg_bytes = local_bytes((pspecs, batch))
            with torch.no_grad(), counter:
                out = prefill(pspecs, batch, cfg, ctx, cache_len=info["seq"])
        else:  # decode
            B = info["batch"]
            cache = S.cache_specs_from_eval(cfg, shape_name, ctx)
            tok = S.stand_in((B, 1), torch.int32, ("batch", None), ctx)
            # + the int32 position, which an SSM's step does not read
            arg_bytes = local_bytes((pspecs, tok, cache)) + (0 if cfg.family == "ssm" else 4)
            with torch.no_grad(), counter:
                out = decode_step(pspecs, tok, cache, info["seq"] - 1, cfg, ctx)
        t_lower = time.time() - t0
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "strategy": strategy,
        "status": "ok",
        "lower_s": round(t_lower, 1),
        "compile_s": None,
        "xla_flops_raw": None,
        "xla_bytes_raw": None,
        "flops": counter.flops,
        "dot_bytes": counter.dot_bytes,
        "collective_bytes": counter.collective_bytes,
        "collectives": dict(counter.collectives),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": local_bytes(out),
            "temp_bytes": None,
            "peak_bytes": None,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(S.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--json", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp", "fsdp_ep", "auto"])
    ap.add_argument("--remat-policy", default=None, choices=[None, "full", "dots"])
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(S.SHAPES) if args.all or not args.shape else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]

    results = []
    failed = 0
    for mp in pods:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {mesh_name(mp)}"
                try:
                    rec = lower_cell(arch, shape, mp, args.microbatches, args.strategy,
                                     args.remat_policy)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mp),
                           "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                    failed += 1
                results.append(rec)
                if rec["status"] == "ok":
                    print(f"[dryrun] OK  {tag}: trace {rec['lower_s']}s, "
                          f"flops {rec['flops']:.3e}, coll {rec['collective_bytes']:.3e}B, "
                          f"args/device {rec['memory']['argument_bytes'] / 2**30:.2f} GiB",
                          flush=True)
                elif rec["status"] == "skipped":
                    print(f"[dryrun] SKIP {tag}: {rec['reason']}", flush=True)
                else:
                    print(f"[dryrun] FAIL {tag}: {rec['error']}", flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"[dryrun] {sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, {failed} failed")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
