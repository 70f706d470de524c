"""chip_smoke.py's dry-run phase (phase R) rehearsed on the CPU: the dry
run's command line in a subprocess a cell, a full-size decode cell traced
and a full-attention arch's long_500k skipped; the phase stops at a cell
that fails or comes back with another status."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import pytest

import chip_smoke

LM = chip_smoke.LM_ARCH


def test_dryrun_phase_rehearsal(tmp_path, capsys):
    recs = chip_smoke.dryrun_phase(str(tmp_path), ((LM, "decode_32k", "ok"),
                                                   (LM, "long_500k", "skipped")))
    out = capsys.readouterr().out
    ok, skipped = recs
    assert ok["status"] == "ok" and ok["mesh"] == "16x16" and ok["flops"] > 0
    assert ok["collective_bytes"] > 0 and ok["memory"]["argument_bytes"] > 0
    assert skipped["status"] == "skipped"
    assert f"{LM} x decode_32k x 16x16 (tp): ok, per device flops" in out
    assert "argument bytes" in out and "trace" in out
    assert "2 subprocesses, started together" in out
    assert f"{LM} x long_500k: skipped (full-attention arch" in out


def test_dryrun_phase_stops_at_a_failed_cell(tmp_path):
    with pytest.raises(AssertionError, match="dry run no-such-arch x decode_32k exited 1"):
        chip_smoke.dryrun_phase(str(tmp_path), (("no-such-arch", "decode_32k", "ok"),))


def test_dryrun_phase_holds_a_cell_to_its_bound(tmp_path, capsys):
    """A cell of `bounds` within its factor of the reference's count is
    logged; one over it stops the phase."""
    cell = ((LM, "decode_32k", "ok"),)
    [rec] = chip_smoke.dryrun_phase(str(tmp_path), cell,
                                    {(LM, "decode_32k"): (1e30, 1.02)})
    assert "x the reference's 1.0000e+30 FLOPs a device (at most 1.02x)" in \
        capsys.readouterr().out
    with pytest.raises(AssertionError, match="FLOPs a device, .* over 1.02x"):
        chip_smoke.dryrun_phase(str(tmp_path), cell, {(LM, "decode_32k"): (rec["flops"] / 1.03,
                                                                           1.02)})
    assert chip_smoke.DRYRUN_BOUNDS[LM, "train_4k"] == (1.0105e14, 1.02)
    assert chip_smoke.DRYRUN_BOUNDS["mamba2-370m", "decode_32k"] == (3.81599744e8, 1.02)
    assert chip_smoke.DRYRUN_BOUNDS["hymba-1.5b", "decode_32k"] == (2.000900096e9, 1.02)
    assert ("hymba-1.5b", "decode_32k", "ok") in chip_smoke.DRYRUN_CELLS
    assert chip_smoke.DRYRUN_BOUNDS["gemma-7b", "train_4k"] == (2.86778837696512e14, 1.02)
    assert chip_smoke.DRYRUN_BOUNDS["whisper-base", "decode_32k"] == (2.59825664e8, 1.02)
    assert ("gemma-7b", "train_4k", "ok") in chip_smoke.DRYRUN_CELLS
    assert ("whisper-base", "decode_32k", "ok") in chip_smoke.DRYRUN_CELLS


def test_dryrun_phase_holds_a_cell_to_its_all_gather_bound(tmp_path, capsys):
    """A cell of `gathers` within its all-gather bytes is logged; one over
    them stops the phase (deepseek-moe-16b's decode, ROADMAP C.6)."""
    cell = ((LM, "decode_32k", "ok"),)
    [rec] = chip_smoke.dryrun_phase(str(tmp_path), cell, {}, {(LM, "decode_32k"): 1e30})
    assert "all-gather bytes a device (at most 1.0000e+30)" in capsys.readouterr().out
    assert rec["collectives"]["all-gather"] > 0
    with pytest.raises(AssertionError, match="all-gather bytes a device, over"):
        chip_smoke.dryrun_phase(str(tmp_path), cell, {}, {(LM, "decode_32k"): 1.0})
    assert chip_smoke.DRYRUN_GATHERS == {("deepseek-moe-16b", "decode_32k"): 6.214e9}


def test_dryrun_phase_stops_at_a_cell_of_another_status(tmp_path):
    with pytest.raises(AssertionError, match="status skipped, not ok"):
        chip_smoke.dryrun_phase(str(tmp_path), ((LM, "long_500k", "ok"),))
