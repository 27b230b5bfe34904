"""Sharded phase-A scan must equal the single-device matrix bit-for-bit."""
import pytest
import numpy as np

import jax

from burst_tpu.alphabet import score_matrix
from burst_tpu.engine import compute_ed_matrix
from burst_tpu.io.fasta import write_fasta  # noqa: F401 (import check)
from burst_tpu.parallel.mesh import compute_ed_matrix_sharded
from burst_tpu.process import process_queries, process_references

from . import golden


def _dataset(seed=5, n_refs=30, n_reads=24):
    rng = np.random.default_rng(seed)
    refs = golden.make_refs(rng, n_refs, lo=150, hi=500)
    reads = golden.make_reads(rng, refs, n_reads, read_len=100, max_err=2)
    rh = [h.encode() for h, _ in refs]
    rs = [np.frombuffer(s.encode(), dtype=np.uint8) for _, s in refs]
    qh = [h.encode() for h, _ in reads]
    qs = [np.frombuffer(s.encode(), dtype=np.uint8) for _, s in reads]
    qd = process_queries(qh, qs, 0.95, do_rc=True)
    rd = process_references(rh, rs, max_len_q=qd.max_len, thres=0.95)
    return qd, rd


def test_eight_device_mesh_available():
    assert len(jax.devices()) >= 8


@pytest.mark.full
def test_sharded_matches_single_device():
    qd, rd = _dataset()
    sm = score_matrix()
    single = compute_ed_matrix(qd, rd, sm)
    for shards in (2, 8):
        sharded = compute_ed_matrix_sharded(qd, rd, sm, shards)
        assert np.array_equal(single, sharded), shards


def test_2d_mesh_matches_single_device():
    """Query blocks sharded along 'q' AND db along 'db' (2 x 4 mesh)."""
    qd, rd = _dataset()
    sm = score_matrix()
    single = compute_ed_matrix(qd, rd, sm)
    sharded = compute_ed_matrix_sharded(qd, rd, sm, 4, q_shards=2)
    assert np.array_equal(single, sharded)


def test_2d_mesh_accel_production_helpers():
    """The production accel helpers (phase A pairs + phase B rescore)
    on a (q=2, db=4) mesh are bit-identical to single-device
    (VERDICT round 1, next-round #9)."""
    import io

    from burst_tpu import engine, modes
    from burst_tpu.accel import build_accelerator
    from burst_tpu.parallel import mesh as pmesh
    from burst_tpu.process import bin_queries_for_accel

    rng = np.random.default_rng(31)
    refs = golden.make_refs(rng, 30, lo=300, hi=900)
    reads = golden.make_reads(rng, refs, 300, read_len=100, max_err=2,
                              rc_frac=0.3)
    rh = [h.encode() for h, _ in refs]
    rs = [np.frombuffer(s.encode(), dtype=np.uint8).copy()
          for _, s in refs]
    qh = [h.encode() for h, _ in reads]
    qs = [np.frombuffer(s.encode(), dtype=np.uint8).copy()
          for _, s in reads]
    from burst_tpu.process import process_queries, process_references
    rd = process_references(rh, rs, max_len_q=100, thres=0.97,
                            rebase=True, rebase_amt=320, curate=2)
    qd = process_queries(qh, qs, 0.97, do_rc=True)
    acc = build_accelerator(rd, k=12, z=1)
    qbins = bin_queries_for_accel(qd, acc.k, 1)
    visits = engine.accel_candidates(qd, rd, acc, qbins, qbunch=1)
    sm = score_matrix()

    def run(n_shards, q_shards):
        if n_shards == 1:
            sed = engine.compute_ed_matrix_accel(qd, rd, visits, sm)
        else:
            sed = pmesh.compute_ed_matrix_accel_sharded(
                qd, rd, visits, sm, n_shards, q_shards=q_shards)
        juni, refpos, eds = engine.select_pods(qd, rd, sed, "BEST")
        order = engine.accel_pod_order(qd, rd, visits, juni, refpos,
                                       eds)
        if n_shards == 1:
            pods = engine.rescore_winners(qd, rd, juni, refpos, eds,
                                          "BEST", sm, order)
        else:
            # windowed sharded rescore (the production configuration;
            # the full-width form is exercised by passing no win_cols
            # in the 2x4 call below)
            wc = sed.lookup_cols(juni, refpos, rd.tot_units) \
                if n_shards == 4 else None
            pods = pmesh.rescore_winners_sharded(
                qd, rd, juni, refpos, eds, "BEST", sm, n_shards, order,
                q_shards=q_shards, win_cols=wc)
        buf = io.StringIO()
        modes.report_best(pods, qd, rd, modes.B6Writer(buf))
        return buf.getvalue()

    single = run(1, 1)
    assert single == run(4, 2) != ""
    assert single == run(2, 4)


@pytest.mark.full
def test_sharded_accel_path_bit_identical(tmp_path):
    """Full accel pipeline with --shards N must produce the same b6
    bytes as the single-device path (db-sharded phase A + phase B)."""
    import subprocess
    import sys
    rng = np.random.default_rng(77)
    refs = golden.make_refs(rng, 30, lo=300, hi=900)
    reads = golden.make_reads(rng, refs, 200, read_len=100, max_err=2)
    rfa = str(tmp_path / "r.fa")
    qfa = str(tmp_path / "q.fa")
    golden.write_fasta(rfa, refs)
    golden.write_fasta(qfa, reads)
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the virtual 8-device CPU mesh is what this test shards over
    env = dict(os.environ, BURST_TPU_SCOUR_N="12",
               JAX_PLATFORMS="cpu", PYTHONPATH=repo,
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=8")
    edx, acx = str(tmp_path / "d.edx"), str(tmp_path / "d.acx")
    subprocess.run([sys.executable, "-m", "burst_tpu.cli", "-r", rfa,
                    "-o", edx, "-a", acx, "-d", "DNA", "320", "-s"],
                   check=True, env=env, capture_output=True)
    for mode in ("BEST", "ALLPATHS", "CAPITALIST"):
        outs = []
        for shards in ("1", "4"):
            out = str(tmp_path / f"o_{mode}_{shards}.b6")
            subprocess.run(
                [sys.executable, "-m", "burst_tpu.cli", "-r", edx,
                 "-a", acx, "-q", qfa, "-o", out, "-m", mode,
                 "--shards", shards],
                check=True, env=env, capture_output=True)
            outs.append(out)
        assert golden.diff_files(*outs) is None, mode
