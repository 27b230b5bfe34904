"""Phase-A Myers kernel vs the exact DP oracle."""
import numpy as np
import pytest

from burst_tpu.alphabet import score_matrix, translate_str
from burst_tpu.kernels.refdp import edit_distance_glocal
from burst_tpu.kernels import myers

SM = score_matrix()
SM_Y = score_matrix(0)


def rand_codes(rng, n, ambig=False):
    return rng.integers(1, 16 if ambig else 5, size=n).astype(np.uint8)


@pytest.mark.parametrize("seed,ambig,zmat", [
    (0, False, SM), (1, False, SM), (2, True, SM), (3, True, SM_Y),
    (4, False, SM_Y), (5, True, SM),
])
def test_single_pairs_match_oracle(seed, ambig, zmat):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        m = int(rng.integers(1, 90))
        L = int(rng.integers(1, 150))
        q = rand_codes(rng, m, ambig)
        r = rand_codes(rng, L, ambig)
        expect = min(edit_distance_glocal(q, r, zmat), 255)
        got = myers.min_ed_numpy_reference(q, r, smat=zmat)
        assert got == expect, (m, L, seed)


def test_multiword_long_queries():
    rng = np.random.default_rng(7)
    for m, L in [(33, 50), (64, 100), (100, 300), (130, 200), (250, 400)]:
        q = rand_codes(rng, m)
        r = rand_codes(rng, L)
        assert myers.min_ed_numpy_reference(q, r, smat=SM) == \
            edit_distance_glocal(q, r, SM)


def test_batched_mixed_lengths_one_bucket():
    """Queries of different lengths within one W bucket, varied tiles."""
    rng = np.random.default_rng(11)
    W = 2  # bucket: qlen in (32, 64]
    B = 16
    qlens = rng.integers(33, 65, size=B)
    maxq = 64
    qs = np.zeros((B, maxq), dtype=np.uint8)
    for i, ln in enumerate(qlens):
        qs[i, :ln] = rand_codes(rng, ln)
    L = 120
    tiles = np.zeros((B, L + W * 32), dtype=np.uint8)
    tlens = rng.integers(40, L + 1, size=B)
    for i, ln in enumerate(tlens):
        tiles[i, :ln] = rand_codes(rng, ln)
    peq = myers.build_peq(qs, qlens, W, SM)
    got = np.asarray(myers.myers_min_ed(peq, tiles, W))
    for i in range(B):
        expect = edit_distance_glocal(qs[i, :qlens[i]], tiles[i, :tlens[i]], SM)
        assert got[i] == expect, i


def test_planted_errors_bound():
    """Reads simulated with k errors must yield ED <= k (optimality)."""
    rng = np.random.default_rng(3)
    ref = rand_codes(rng, 2000)
    for k in (0, 1, 2, 5):
        start = int(rng.integers(0, 1800))
        read = ref[start:start + 120].copy()
        pos = rng.choice(120, size=k, replace=False)
        for p in pos:
            read[p] = 1 + ((read[p] + int(rng.integers(0, 3))) % 4)
        ed = myers.min_ed_numpy_reference(read, ref, smat=SM)
        assert ed <= k


def test_exact_match_found_in_padded_tile():
    r = translate_str("ACGTACGTTTGCAGGCATACGT" * 5)
    q = r[13:47].copy()
    assert myers.min_ed_numpy_reference(q, r, smat=SM) == 0
