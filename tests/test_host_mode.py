"""BURST_TPU_HOST=1: byte-identical output with no device touched.

Host mode routes every dispatch site to kernels/host.py; it must
reproduce the device-path bytes exactly.
"""
import numpy as np
import pytest

from burst_tpu import devtime
from burst_tpu.accel import build_accelerator
from burst_tpu.process import process_references
from burst_tpu.serving import Aligner


def _workload(seed=5, n_refs=25, ref_len=500, n_reads=200):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [rng.choice(bases, size=ref_len) for _ in range(n_refs)]
    rheads = [f"r{i:03d}".encode() for i in range(n_refs)]
    reads, qheads = [], []
    for i in range(n_reads):
        s = refs[int(rng.integers(0, n_refs))]
        st = int(rng.integers(0, ref_len - 100))
        r = s[st:st + 100].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 100))] = bases[int(rng.integers(0, 4))]
        if i % 23 == 0:
            r[int(rng.integers(0, 100))] = ord("N")
        reads.append(r)
        qheads.append(f"q{i:05d}".encode())
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=100, thres=0.98, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    return rd, acc, qheads, reads


@pytest.mark.parametrize("mode", ["BEST", "ALLPATHS", "CAPITALIST",
                                  "FORAGE", "ANY"])
def test_host_mode_byte_identical(mode, monkeypatch):
    rd, acc, qheads, reads = _workload()
    ref = Aligner(rd, acc, thres=0.98, mode=mode, do_rc=True
                  ).align_batch(qheads, [r.copy() for r in reads])
    monkeypatch.setenv("BURST_TPU_HOST", "1")
    assert not devtime.device_ok()
    got = Aligner(rd, acc, thres=0.98, mode=mode, do_rc=True
                  ).align_batch(qheads, [r.copy() for r in reads])
    assert got == ref and ref.count(b"\n") > 100


def test_host_mode_direct_path(monkeypatch):
    """Non-accel full path (streamed compute_ed_select) in host mode."""
    rd, _, qheads, reads = _workload(n_refs=10, n_reads=60)
    ref = Aligner(rd, None, thres=0.98, mode="BEST", do_rc=True
                  ).align_batch(qheads, [r.copy() for r in reads])
    monkeypatch.setenv("BURST_TPU_HOST", "1")
    got = Aligner(rd, None, thres=0.98, mode="BEST", do_rc=True
                  ).align_batch(qheads, [r.copy() for r in reads])
    assert got == ref and ref.count(b"\n") > 30
