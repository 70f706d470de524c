"""chip_smoke.py's mesh phase (phase D: serving under a device mesh)
rehearsed on the CPU with plain kernels counted as launches: qwen3's smoke
config at float32 and 2 layers in place of the full width, prompts of 24-48
tokens with 8 new each on 64-slot caches, and the launcher on the smoke
config; a gloo process group
of one rank on a HashStore in place of NCCL.  It passes every check (on one
rank the mesh serves bit for bit as no mesh does), launches one bitunpack
in its window, and destroys its process group, also when a check fails.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch.distributed as dist

import chip_smoke
from tests.test_torch_chip_smoke import on_cpu, plain_launches  # noqa: F401 (fixtures)


@pytest.fixture
def mesh_on_cpu(monkeypatch, on_cpu, plain_launches):  # noqa: F811
    from repro_torch.configs import get_smoke_config

    monkeypatch.setattr(chip_smoke, "get_config", lambda arch: dataclasses.replace(
        get_smoke_config(arch), dtype="float32", n_layers=2))
    monkeypatch.setattr(chip_smoke, "LM_PROMPTS", (24, 32, 40, 48))
    monkeypatch.setattr(chip_smoke, "LM_MAX_LEN", 64)
    monkeypatch.setattr(chip_smoke, "MESH_NEW_TOKENS", 8)
    monkeypatch.setattr(chip_smoke, "SERVE_ARGS", chip_smoke.SERVE_ARGS + ["--smoke"])


def test_mesh_phase_rehearsal(mesh_on_cpu, capsys):
    launches = chip_smoke.mesh_phase(0, device="cpu")
    out = capsys.readouterr().out
    for part in ("mesh {'data': 1, 'model': 1} over gloo, strategy tp",
                 "(a) 4 requests of [24, 32, 40, 48] tokens, 8 new each (32 tokens)",
                 "the same tokens under the mesh and without it",
                 "max |diff| 0.000e+00, relative L2 0.000e+00 (bit for bit",
                 "(a) mesh: prefill_ms (24 tokens, warm)", "(a) none: prefill_ms",
                 "idle_share=", "(b) 4096-token prompt packed at k=9 under the mesh: one "
                 "bitunpack launch", "(c) launch.serve --arch qwen3-1.7b --requests 16 --smoke: "
                 "16 requests, 256 tokens", "(d) process group destroyed"):
        assert part in out, part
    assert launches == dict(dict.fromkeys(chip_smoke.ops.KERNELS, 0), bitunpack=1)
    assert not dist.is_initialized()


def test_mesh_phase_stops_when_the_mesh_engine_differs(mesh_on_cpu, monkeypatch, capsys):
    """An engine under the mesh whose tokens come back one off: the phase
    raises at (a)'s comparison, prints nothing after it, and still destroys
    its process group."""
    served = chip_smoke.served_on

    def off_by_one(params, cfg, ctx, reqs, device):
        run = served(params, cfg, ctx, reqs, device)
        if ctx is not None:
            run["tokens"] = {rid: [t + 1 for t in out] for rid, out in run["tokens"].items()}
        return run

    monkeypatch.setattr(chip_smoke, "served_on", off_by_one)
    with pytest.raises(AssertionError, match=r"\(a\) the engine under the mesh gave other tokens"):
        chip_smoke.mesh_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "(a)" not in out and "(b)" not in out
    assert not dist.is_initialized()
