"""chip_smoke.py rehearsed on the CPU at a tiny size.

On the CPU backend engine dispatches XLA's kernels, so these runs check
the phases' control flow and references; the card run checks the
compiled kernels. main() itself refuses to run without a GPU.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

TINY = dict(n_fam=6, n_mem=3, fam_len=2000, n_reads=240)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_needs_a_gpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_device_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_device(require_gpu=True)
    info = chip_smoke.phase_device(require_gpu=False)
    assert info["platform"] == "cpu" and info["count"] >= 1


def test_phase_kernels_tiny():
    chip_smoke.phase_kernels(n_pairs=96, n_tiles=24, n_queries=16,
                             widths=((4, 100, 417), (8, 256, 544)),
                             n_oracle=4)


def test_phase_rescore_tiny():
    chip_smoke.phase_rescore(n_pairs=64, n_tiles=16, n_queries=16,
                             widths=((4, 100),), n_oracle=3)


def test_phase_scour_and_e2e_tiny(monkeypatch):
    monkeypatch.setenv("BURST_TPU_DEV_SCOUR", "1")
    monkeypatch.setenv("BURST_TPU_SCOUR_E", "512")
    rheads, refs, qheads, reads = bench.make_workload(**TINY)
    rd, acc = chip_smoke.build_db(rheads, refs)
    chip_smoke.phase_scour(rd, acc, qheads[:120], reads[:120],
                           bench.THRES)
    got = chip_smoke.phase_e2e(rd, acc, qheads, reads, bench.THRES,
                               batch=128)
    assert got["reads_per_s"] > 0


def test_phase_four_cards_virtual_mesh(tmp_path):
    """--shards 4 over four of the virtual CPU devices."""
    chip_smoke.phase_four_cards(str(tmp_path), workload=TINY)
