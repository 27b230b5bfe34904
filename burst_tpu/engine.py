"""Alignment engine: bucketed phase-A scan + phase-B rescore -> result pods.

This is the accelerator replacement for the reference's do_alignments
orchestrator (/root/reference/burst.c:3632-4521). Instead of the
reference's sequential clump sweep with prefix-seek stacks, all
(unique-query x reference-unit) pairs are evaluated in batched device
kernels; budgets, tie selection and pod ordering are applied afterwards
on the result matrix, which reproduces the reference's surviving pod set
and its single-thread full-path insertion order exactly
(pods sorted by descending (clump, query-row, lane)).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import devtime
from .alphabet import score_matrix
from .kernels import myers
from .kernels.rescore import (  # noqa: F401
    rescore_finalize, rescore_finalize_host, rescore_pairs,
    rescore_pairs_gather, rescore_pairs_gather_async)
from .process import QueryData, RefData

VECSZ = 16  # the reference's clump width; defines pod ordering only


@dataclasses.dataclass
class Pods:
    """Columnar result pods (one row per surviving (query, unit) hit)."""
    six: np.ndarray        # base unique-query index
    juni: np.ndarray       # unibin row (fwd: six, rc: six + numUniq)
    refpos: np.ndarray     # position in sorted/dedup unit order ("refIx")
    ed: np.ndarray         # mismatches (total edit distance)
    rc: np.ndarray
    gap_q: np.ndarray
    gap_r: np.ndarray
    final_pos: np.ndarray
    score: np.ndarray      # float32 identity


def _bucket_queries(qd: QueryData):
    """Group unibin rows by Myers word count W."""
    buckets: dict[int, list[int]] = {}
    for j, s in enumerate(qd.seqs):
        buckets.setdefault(myers.words_for(len(s)), []).append(j)
    return buckets


def _bucket_units(rd: RefData, granularity: int = 64):
    """Group sorted unit positions by padded tile length.

    A host-range .edx shard (db/edx.read_edx clump_range) sets
    rd.unit_range; units outside it are non-local -- another host owns
    and scans them -- and are skipped here, so every kernel pass over
    this rd touches local tiles only."""
    ur = getattr(rd, "unit_range", None)
    lo, hi = (0, rd.tot_units) if ur is None else ur
    buckets: dict[int, list[int]] = {}
    for p in range(lo, min(hi, rd.tot_units)):
        ln = int(rd.lens[rd.ix_srt[p]])
        lb = -(-max(ln, 1) // granularity) * granularity
        buckets.setdefault(lb, []).append(p)
    return buckets


QCHUNK = 2048   # canonical query-block height (fixed shapes -> one compile)
TCHUNK = 512    # canonical tile-block width


def _query_matrix(qd: QueryData):
    """Cached [nj, 32*Wmax] padded query matrix + per-row lengths/W."""
    cache = getattr(qd, "_qmat", None)
    if cache is not None:
        return cache
    nj = len(qd.seqs)
    qlens = np.array([len(s) for s in qd.seqs], dtype=np.int64)
    wmax = max(1, int(-(-qlens.max() // 32))) if nj else 1
    qmat = np.zeros((nj, wmax * 32), dtype=np.uint8)
    for j, s in enumerate(qd.seqs):
        qmat[j, : len(s)] = s
    qw = np.maximum(1, -(-qlens // 32))
    cache = (qmat, qlens, qw)
    qd._qmat = cache
    return cache


def _fill_rows(mat: np.ndarray, rd: RefData, positions: np.ndarray):
    """Copy units (sorted positions) into the zero-padded row matrix.

    Chunked native memcpy: the per-row Python loop costs minutes on a
    multi-GB bucket (tens of millions of rows); chunking bounds the
    concatenation scratch."""
    from .native import pad_rows_native
    seqs, ix = rd.seqs, rd.ix_srt
    step = 1 << 20
    for c0 in range(0, len(positions), step):
        chunk = [seqs[ix[p]] for p in positions[c0:c0 + step]]
        lens = np.fromiter((len(s) for s in chunk), np.int64,
                           count=len(chunk))
        offs = np.zeros(len(chunk) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        cat = np.concatenate(chunk) if chunk else np.zeros(0, np.uint8)
        if not pad_rows_native(cat, offs, mat[c0:c0 + len(chunk)]):
            for i, s in enumerate(chunk):
                mat[c0 + i, : len(s)] = s


def _tile_matrix(rd: RefData, lb: int, positions: np.ndarray, pad: int):
    """Cached [n, lb+pad] padded tile matrix for one length bucket."""
    cache = getattr(rd, "_tilecache", None)
    if cache is None:
        cache = {}
        rd._tilecache = cache
    key = (lb, pad)
    got = cache.get(key)
    if got is not None:
        return got
    mat = np.zeros((len(positions), lb + pad), dtype=np.uint8)
    _fill_rows(mat, rd, positions)
    pos2row = np.full(rd.tot_units, -1, dtype=np.int64)
    pos2row[positions] = np.arange(len(positions))
    cache[key] = (mat, pos2row)
    return cache[key]


def _peq_cache(qd: QueryData, W: int, smat: np.ndarray):
    """Per-(W, scoring-matrix) Peq tables for the W-bucket's rows.

    Returns (row2local [nj] int64 with -1 for rows outside the bucket,
    peq [n_bucket, 16, W] uint32)."""
    cache = getattr(qd, "_peqcache", None)
    if cache is None:
        cache = {}
        qd._peqcache = cache
    key = (W, smat.tobytes())
    got = cache.get(key)
    if got is not None:
        return got
    qmat, qlens, qw = _query_matrix(qd)
    rows = np.nonzero(qw == W)[0]
    if getattr(qd, "xalpha", False):
        peq = myers.build_peq_x(qmat[rows, : 32 * W], qlens[rows], W)
    else:
        peq = myers.build_peq(qmat[rows, : 32 * W], qlens[rows], W, smat)
    row2local = np.full(len(qd.seqs), -1, dtype=np.int64)
    row2local[rows] = np.arange(len(rows))
    cache[key] = (row2local, peq)
    return cache[key]


def _peq_device(qd: QueryData, W: int, smat: np.ndarray):
    """Device-resident pow2-padded Peq for the W bucket."""
    cache = getattr(qd, "_peqdev", None)
    if cache is None:
        cache = {}
        qd._peqdev = cache
    key = (W, smat.tobytes())
    got = cache.get(key)
    if got is None:
        import jax.numpy as jnp
        row2local, peq = _peq_cache(qd, W, smat)
        n = _pow2_ceil(max(1, peq.shape[0]))
        padded = np.zeros((n, peq.shape[1], W), dtype=np.uint32)
        padded[: peq.shape[0]] = peq
        got = cache[key] = (row2local, jnp.asarray(padded))
    return got


def prefetch_query_planes(qd: QueryData, smat: np.ndarray):
    """Start the async host->device upload of every W-bucket's Peq.

    jnp.asarray returns immediately; the transfer streams in the
    background. Calling this right after process_queries lets the
    query-plane upload overlap the host-side k-mer scour instead of
    serializing in front of the phase-A kernel dispatch."""
    if not devtime.device_ok():
        return
    _, _, qw = _query_matrix(qd)
    for W in np.unique(qw):
        _peq_device(qd, int(W), smat)


def _tiles_device(rd: RefData, lb: int, pad: int):
    """Device-resident pow2-padded tile matrix for one length bucket."""
    cache = getattr(rd, "_tiledev", None)
    if cache is None:
        cache = {}
        rd._tiledev = cache
    key = (lb, pad)
    got = cache.get(key)
    if got is None:
        import jax.numpy as jnp
        bpos = np.nonzero(_unit_lb(rd) == lb)[0]
        tmat, pos2row = _tile_matrix(rd, lb, bpos, pad)
        n = _pow2_ceil(max(1, tmat.shape[0]))
        padded = np.zeros((n, tmat.shape[1]), dtype=np.uint8)
        padded[: tmat.shape[0]] = tmat
        got = cache[key] = (pos2row, jnp.asarray(padded))
    return got


def _unit_lb(rd: RefData, granularity: int = 64):
    """[tot_units] padded length bucket per sorted position (cached)."""
    lbs = getattr(rd, "_unit_lb", None)
    if lbs is None:
        ulen = rd.lens[rd.ix_srt[: rd.tot_units]]
        lbs = (-(-np.maximum(ulen, 1) // granularity) * granularity
               ).astype(np.int64)
        rd._unit_lb = lbs
    return lbs


# Tile-store budget where the device reports no memory limit (the CPU
# backend the tests run on).
CPU_TILE_BUDGET = 2 << 30


def _tile_budget_bytes() -> int:
    """Device-resident tile budget. Buckets under it stay pinned in
    device memory (cached across batches); buckets over it stream in
    double-buffered slabs so a database far larger than the card still
    runs (the reference's headline DB is 31.5 GB:
    /root/reference/README.md:16). Half of the device's memory limit:
    the other half holds the postings tables, the rescore tiles and the
    scour chunks' working set. BURST_TPU_TILE_HBM_MB overrides it."""
    import os
    mb = os.environ.get("BURST_TPU_TILE_HBM_MB")
    if mb is not None:
        return int(float(mb) * (1 << 20))
    import jax
    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return CPU_TILE_BUDGET
    return int(stats["bytes_limit"]) // 2


def _slab_rows_for(n_rows: int, width: int) -> int | None:
    """None = the [n_rows, width] tile matrix fits the resident budget;
    else the slab height (multiple of 8) sized so two slabs in flight
    stay under the budget."""
    budget = _tile_budget_bytes()
    if n_rows * width <= budget:
        return None
    rows = max(1024, budget // (2 * max(width, 1)))
    return -(-rows // 8) * 8


def _use_triton(W: int, peq_dev) -> bool:
    """The phase-A Triton kernel runs on a GPU when the query fits its
    register budget; XLA's scan serves every other case."""
    import jax

    from .kernels.myers_triton import MAX_W
    return jax.devices()[0].platform == "gpu" and W <= MAX_W and \
        peq_dev.shape[1] == 16


def _myers_pairs_dispatch(peq_dev, tiles_dev, pidx, tidx, W: int):
    """Phase-A pair scan over a [NT, Lp] one-code-per-byte tile store."""
    if _use_triton(W, peq_dev):
        from .kernels.myers_triton import myers_pairs_triton_codes
        return myers_pairs_triton_codes(peq_dev, tiles_dev, pidx, tidx,
                                        W=int(W))
    return myers.myers_min_ed_gather_pos(peq_dev, tiles_dev, pidx,
                                         tidx, int(W))


def _myers_pairs_dispatch_packed(peq_dev, words, Lp: int, pidx, tidx,
                                 W: int):
    """Phase-A pair scan over the packed-word tile store (Lp = logical
    width; see myers.pack_words_np)."""
    if _use_triton(W, peq_dev):
        from .kernels.myers_triton import myers_pairs_triton
        return myers_pairs_triton(peq_dev, words, pidx, tidx, W=int(W),
                                  Lp=int(Lp))
    return myers.myers_min_ed_gather_pos_packed(peq_dev, words, pidx,
                                                tidx, int(W), int(Lp))


def _host_cross(pq: np.ndarray, tb: np.ndarray, W: int) -> np.ndarray:
    """Host twin of myers.myers_min_ed_cross: [Q, T] min-ED block."""
    from .kernels.host import myers_pairs_host
    Q, T = pq.shape[0], tb.shape[0]
    pidx = np.repeat(np.arange(Q, dtype=np.int32), T)
    tidx = np.tile(np.arange(T, dtype=np.int32), Q)
    return myers_pairs_host(pq, tb, pidx, tidx, W)[0].reshape(Q, T)


def iter_ed_blocks(qd: QueryData, rd: RefData, smat: np.ndarray,
                   max_pending: int = 16):
    """Stream phase-A blocks: yields (rows, poss, block_u8) host tiles
    of the min-ED matrix without ever assembling it.

    Device dispatch runs ahead of the host by up to `max_pending`
    blocks (fetched in one batched device_get per group); host memory
    is O(block), not O(nj x tot_units)."""
    import jax

    qbuckets = _bucket_queries(qd)
    ubuckets = _bucket_units(rd)
    qmat, qlens_all, _ = _query_matrix(qd)
    pending = []

    def _drain():
        host = devtime.fetch([b for _, _, b, _, _ in pending])
        out = []
        for (rws, pss, _, nq, nt), block in zip(pending, host):
            block = np.minimum(block, 255).astype(np.uint8)
            out.append((rws, pss, block[:nq, :nt]))
        pending.clear()
        return out

    for W, rows in sorted(qbuckets.items()):
        m_pad = W * 32
        rows_a = np.array(rows, dtype=np.int64)
        qarr = qmat[rows_a, :m_pad]
        qlens = qlens_all[rows_a]
        if getattr(qd, "xalpha", False):
            peq = myers.build_peq_x(qarr, qlens, W)
        else:
            peq = myers.build_peq(qarr, qlens, W, smat)
        for lb, poss in sorted(ubuckets.items()):
            tiles, _ = _tile_matrix(rd, int(lb), np.array(poss), 32)
            qchunk = min(QCHUNK, _pow2_ceil(len(rows)))
            tchunk = min(TCHUNK, _pow2_ceil(len(poss)))
            use_dev = devtime.device_ok()
            for q0 in range(0, len(rows), qchunk):
                pq = _pad_rows(peq[q0:q0 + qchunk], qchunk)
                for t0 in range(0, len(poss), tchunk):
                    tb = _pad_rows(tiles[t0:t0 + tchunk], tchunk)
                    nq = min(qchunk, len(rows) - q0)
                    nt = min(tchunk, len(poss) - t0)
                    block = myers.myers_min_ed_cross(pq, tb, W) \
                        if use_dev else _host_cross(pq, tb, W)
                    pending.append((rows[q0:q0 + nq], poss[t0:t0 + nt],
                                    block, nq, nt))
                    if len(pending) >= max_pending:
                        yield from _drain()
    if pending:
        yield from _drain()


def compute_ed_matrix(qd: QueryData, rd: RefData,
                      smat: np.ndarray | None = None) -> np.ndarray:
    """Phase A: [numUnibins, tot_units] uint8 min-ED matrix (clipped 255).

    Materializes the dense matrix -- fine for test-scale runs and for
    the accel path's few full-scan fallback rows; the production full
    path streams via compute_ed_select instead (burst.c:4318-4521
    streams with a running budget the same way)."""
    if smat is None:
        smat = score_matrix()
    nj = len(qd.seqs)
    ed = np.full((nj, rd.tot_units), 255, dtype=np.uint8)
    for rws, pss, block in iter_ed_blocks(qd, rd, smat,
                                          max_pending=1 << 30):
        ed[np.ix_(rws, pss)] = block
    return ed


def compute_ed_select(qd: QueryData, rd: RefData, mode: str,
                      smat: np.ndarray | None = None,
                      compact_at: int = 1 << 22):
    """Streamed phase A + winner selection: byte-equivalent to
    select_pods(qd, rd, compute_ed_matrix(qd, rd, smat), mode) with
    host memory O(numUniq + winners + block) instead of the dense
    [numUnibins, tot_units] matrix (burst.c:4318-4521's running-budget
    sweep, re-expressed as a running min over streamed device blocks).

    Returns (juni, refpos, eds) in the same (row-major) order the dense
    nonzero scan produces."""
    if smat is None:
        smat = score_matrix()
    nu = qd.num_uniq
    budgets = qd.ed
    budj = budgets[qd.six]                       # per unibin row
    cj: list[np.ndarray] = []
    cp: list[np.ndarray] = []
    ce: list[np.ndarray] = []
    n_cand = 0
    if mode == "FORAGE":
        for rws, pss, block in iter_ed_blocks(qd, rd, smat):
            rws = np.asarray(rws, dtype=np.int64)
            pss = np.asarray(pss, dtype=np.int64)
            r, c = np.nonzero(block <= budj[rws][:, None])
            cj.append(rws[r])
            cp.append(pss[c])
            ce.append(block[r, c].astype(np.int64))
        jj = np.concatenate(cj) if cj else np.zeros(0, np.int64)
        pp = np.concatenate(cp) if cp else np.zeros(0, np.int64)
        ee = np.concatenate(ce) if ce else np.zeros(0, np.int64)
        srt = np.lexsort((pp, jj))
        return jj[srt], pp[srt], ee[srt]

    # tie modes: running per-unique minimum (strand-folded via six)
    best = np.full(nu, 255, dtype=np.int64)

    def _compact():
        nonlocal n_cand
        kept_j, kept_p, kept_e = [], [], []
        for j, p, e in zip(cj, cp, ce):
            k = e == best[qd.six[j]]
            kept_j.append(j[k])
            kept_p.append(p[k])
            kept_e.append(e[k])
        cj[:], cp[:], ce[:] = kept_j, kept_p, kept_e
        n_cand = sum(len(j) for j in cj)

    for rws, pss, block in iter_ed_blocks(qd, rd, smat):
        rws = np.asarray(rws, dtype=np.int64)
        pss = np.asarray(pss, dtype=np.int64)
        sixb = qd.six[rws]
        # keep entries at or under the running min BEFORE this block
        # tightens it: new-min entries survive, stale ones compact away
        cap = np.minimum(budj[rws], best[sixb])
        r, c = np.nonzero(block <= cap[:, None])
        if len(r):
            cj.append(rws[r])
            cp.append(pss[c])
            ce.append(block[r, c].astype(np.int64))
            n_cand += len(r)
        np.minimum.at(best, sixb,
                      block.min(axis=1).astype(np.int64))
        if n_cand > compact_at:
            _compact()
    _compact()
    valid = best <= budgets
    jj = np.concatenate(cj) if cj else np.zeros(0, np.int64)
    pp = np.concatenate(cp) if cp else np.zeros(0, np.int64)
    ee = np.concatenate(ce) if ce else np.zeros(0, np.int64)
    k = valid[qd.six[jj]]
    jj, pp, ee = jj[k], pp[k], ee[k]
    srt = np.lexsort((pp, jj))
    return jj[srt], pp[srt], ee[srt]


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading dim to exactly n rows (canonical kernel shapes)."""
    if a.shape[0] == n:
        return a
    out = np.zeros((n,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def select_pods(qd: QueryData, rd: RefData, ed, mode: str,
                pairs=None):
    """Apply budgets and tie selection; return winner (juni, refpos, ed).

    `ed` is either the dense [numUnibins, tot_units] matrix or a
    SparseED from the accel path (in which case selection runs on the
    sparse pair arrays; the legacy `pairs` argument is ignored).
    """
    nu = qd.num_uniq
    budgets = qd.ed  # [numUniq]
    if isinstance(ed, SparseED):
        ed.materialize()
        pj, pp, pe = ed.pj, ed.pp, ed.pe.astype(np.int64)
        six = qd.six[pj]
        frows = np.asarray(ed.full_rows, dtype=np.int64)
        sub = ed.ed_full
        if mode == "FORAGE":
            keep = pe <= budgets[six]
            out = [(pj[keep], pp[keep], pe[keep])]
            if frows.size:
                mask = sub <= budgets[qd.six[frows]][:, None]
                r, c = np.nonzero(mask)
                out.append((frows[r], c.astype(np.int64),
                            sub[r, c].astype(np.int64)))
        else:
            best = np.full(nu, 255, dtype=np.int64)
            np.minimum.at(best, six, pe)
            if frows.size:
                np.minimum.at(best, qd.six[frows],
                              sub.min(axis=1).astype(np.int64))
            keep = (pe == best[six]) & (pe <= budgets[six])
            out = [(pj[keep], pp[keep], pe[keep])]
            if frows.size:
                fsix = qd.six[frows]
                mask = (sub == best[fsix][:, None]) & \
                    (best[fsix] <= budgets[fsix])[:, None]
                r, c = np.nonzero(mask)
                out.append((frows[r], c.astype(np.int64),
                            sub[r, c].astype(np.int64)))
        return (np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out]),
                np.concatenate([o[2] for o in out]))
    budj = budgets[qd.six]                   # [nj]
    if mode == "FORAGE":
        maskj = ed <= budj[:, None]
    else:
        # fold strands: per-base-query minimum over its unibin rows
        best = np.full(nu, 255, dtype=np.int64)
        np.minimum.at(best, qd.six, ed.min(axis=1).astype(np.int64))
        valid = best <= budgets
        maskj = (ed == best[qd.six][:, None]) & valid[qd.six][:, None]
    jj, pp = np.nonzero(maskj)
    eds = ed[jj, pp].astype(np.int64)
    return jj.astype(np.int64), pp.astype(np.int64), eds


def rescore_winners(qd: QueryData, rd: RefData, juni, refpos, eds,
                    mode: str, smat: np.ndarray | None = None,
                    pod_order: np.ndarray | None = None,
                    last0: np.ndarray | None = None,
                    win_cols=None) -> Pods:
    """Phase B: exact stats for winner pairs, then reference pod ordering.

    `last0` (optional, from SparseED.lookup_last): zero-ED winners have
    no gaps, identity exactly 1.0, and final_pos = the phase-A
    last-best column minus the wildcard pad shift -- they skip the
    rescore kernel entirely.

    `win_cols` (optional, from SparseED.lookup_cols): per-pair
    (first, last) best columns in phase-A padded coordinates. Pairs
    whose tie span fits a narrow window run the rescore DP on a
    [~rows+budget]-column slice of the tile instead of its full width
    -- exact (every min-ED last-row column and every min-cost path
    reaching one lies inside the slice; boundary paths are achievable
    upper bounds), and several times less kernel work on long tiles.
    """
    if smat is None:
        smat = score_matrix()
    n = len(juni)
    gap_q = np.zeros(n, np.int64)
    gap_r = np.zeros(n, np.int64)
    fpos = np.zeros(n, np.int64)
    score = np.zeros(n, np.float32)
    out_ed = np.array(eds, dtype=np.int64)

    budgets = qd.ed
    # rescore bound: the pair's own ED (tie modes) or the query budget
    # (FORAGE/ANY explore all valid refs: burst.c:4437 'min = Emac')
    if mode in ("FORAGE", "ANY"):
        bound = budgets[qd.six[juni]]
    else:
        bound = out_ed

    # bucket pairs like phase A; dispatch all chunks, sync at the end
    pending = []
    order = np.arange(n)
    qmat, qlens_all, qw_all = _query_matrix(qd)
    qws = qw_all[juni] if n else np.zeros(0, np.int64)
    lbs = _unit_lb(rd)[refpos] if n else np.zeros(0, np.int64)
    todo = np.ones(n, dtype=bool)
    if last0 is None and win_cols is not None:
        last0 = win_cols[1]
    if last0 is not None and n:
        skip = (out_ed == 0) & (np.asarray(last0) > 0)
        if skip.any():
            score[skip] = np.float32(1.0)
            fpos[skip] = np.asarray(last0)[skip] - \
                (qws[skip] * 32 - qlens_all[juni[skip]])
            todo &= ~skip
    # per-pair window offsets (see docstring); -1 = full-width
    x0_all = np.full(n, -1, dtype=np.int64)
    span_all = np.zeros(n, dtype=np.int64)
    if win_cols is not None and n:
        first_m = np.asarray(win_cols[0], dtype=np.int64)
        last_m = np.asarray(win_cols[1], dtype=np.int64)
        known = (first_m > 0) & (last_m > 0)
        # x0 = real_first - qlen - bound - 1 in 0-based tile coords;
        # the (rows - qlen) pad shift cancels out of the margin
        x0c = np.maximum(first_m - qws * 32 - bound - 1, 0)
        x0_all[known] = x0c[known]
        span_all[known] = (last_m - first_m)[known]

    def _dispatch(sel, W, lb, use_dev, peq_dev, tiles_dev, peq_h,
                  tiles_h, prows, trows, x0s, Lw):
        # 4x the canonical block: winner batches run ~1 pair/read, so
        # larger chunks cut per-dispatch host glue
        pchunk = min(4 * QCHUNK, _pow2_ceil(len(sel)))
        for s0 in range(0, len(sel), pchunk):
            part = sel[s0:s0 + pchunk]
            pidx = np.zeros(pchunk, np.int32)
            tidx = np.zeros(pchunk, np.int32)
            pidx[: len(part)] = prows[s0:s0 + pchunk]
            tidx[: len(part)] = trows[s0:s0 + pchunk]
            qlens = np.full(pchunk, 2, np.int64)  # dummies stay valid
            qlens[: len(part)] = qlens_all[juni[part]]
            bnd = np.zeros(pchunk, np.int64)
            bnd[: len(part)] = bound[part]
            if x0s is None:
                xc = None
            else:
                xc = np.zeros(pchunk, np.int64)
                xc[: len(part)] = x0s[s0:s0 + pchunk]
            if use_dev:
                out = rescore_pairs_gather_async(
                    peq_dev, tiles_dev, pidx, tidx, qlens, bnd,
                    int(W), smat, x0=xc, Lw=Lw if xc is not None
                    else None)
            else:
                from .kernels.host import rescore_pairs_host
                rows = min(int(W) * 32, -(-int(qlens.max()) // 8) * 8)
                out = rescore_pairs_host(peq_h, tiles_h, pidx, tidx,
                                         qlens, bnd, int(W), rows, xc,
                                         Lw, n=len(part))
            pending.append((part, qlens, out, xc))

    for W in np.unique(qws[todo] if n else qws):
        for lb in np.unique(lbs[todo & (qws == W)]):
            grp = todo & (qws == W) & (lbs == lb)
            m_pad = int(W) * 32
            lp = int(lb) + m_pad
            lp = -(-lp // 64) * 64
            nbkt = int(np.count_nonzero(_unit_lb(rd) == lb))
            use_dev = devtime.device_ok()
            tiles_dev = peq_dev = None
            if _slab_rows_for(nbkt, lp) is not None:
                # bucket over the HBM tile budget: winners are few, so
                # upload a compact submatrix of just their tiles
                pos2row, tiles_dev, tiles_h = _winner_tiles_device(
                    rd, int(lb), lp - int(lb), refpos[grp],
                    want_dev=use_dev)
            else:
                bpos = np.nonzero(_unit_lb(rd) == lb)[0]
                tiles_h, pos2row = _tile_matrix(rd, int(lb), bpos,
                                                lp - int(lb))
                if use_dev:
                    _, tiles_dev = _tiles_device(rd, int(lb),
                                                 lp - int(lb))
            row2local, peq_h = _peq_cache(qd, int(W), smat)
            if use_dev:
                _, peq_dev = _peq_device(qd, int(W), smat)
            # windowed subset: tie span + scan rows + budget must fit Lw
            qmax = int(qlens_all[juni[grp]].max()) if grp.any() else 2
            rows_g = min(m_pad, -(-qmax // 8) * 8)
            bmax = int(bound[grp].max()) if grp.any() else 0
            Lw = -(-(rows_g + bmax + 2) // 128) * 128
            L1_full = -(-(lp + 1) // 128) * 128
            fits = grp & (x0_all >= 0) & \
                (span_all <= Lw - 1 - rows_g - bound - 1)
            if Lw >= L1_full:
                fits &= False
            for sub, x0flag in ((fits, True), (grp & ~fits, False)):
                sel = order[sub]
                if not len(sel):
                    continue
                trows = pos2row[refpos[sel]]
                prows = row2local[juni[sel]]
                _dispatch(sel, W, lb, use_dev, peq_dev, tiles_dev,
                          peq_h, tiles_h, prows, trows,
                          x0_all[sel] if x0flag else None, Lw)
    # one batched fetch for every chunk's packed [4, N] output
    if pending:
        host = devtime.fetch([dev for _, _, dev, _ in pending])
        for ci, (part, qlens, dev, xc) in enumerate(pending):
            h = np.asarray(host[ci])
            m = h.shape[1]          # host chunks are n-wide, not pchunk
            e, gq, gr, fp, sc = rescore_finalize_host(
                h[0], h[1], h[2], h[3], qlens[:m])
            n = len(part)
            gap_q[part] = gq[:n]
            gap_r[part] = gr[:n]
            fpos[part] = fp[:n] + (xc[:n] if xc is not None else 0)
            score[part] = sc[:n]
            out_ed[part] = e[:n]

    # Reference pod ordering: single-thread full-path insertion order is
    # (clump asc, query-row asc, lane asc) head-inserted, i.e. iteration
    # order (clump desc, query-row desc, lane desc) (burst.c:4343-4477).
    # The accel path passes its own visit-rank ordering via pod_order.
    if pod_order is not None:
        srt = pod_order
    else:
        clump = refpos // VECSZ
        lane = refpos % VECSZ
        srt = np.lexsort((-lane, -juni, -clump))
    return Pods(six=qd.six[juni][srt], juni=juni[srt], refpos=refpos[srt],
                ed=out_ed[srt], rc=qd.rc[juni][srt], gap_q=gap_q[srt],
                gap_r=gap_r[srt], final_pos=fpos[srt], score=score[srt])


def align(qd: QueryData, rd: RefData, mode: str,
          smat: np.ndarray | None = None):
    juni, refpos, eds = compute_ed_select(qd, rd, mode, smat)
    return rescore_winners(qd, rd, juni, refpos, eds, mode, smat)


# ------------------------------------------------------------ accel path

@dataclasses.dataclass
class Visits:
    """CSR candidate clump visit lists per unibin (burst.c:4077-4136).

    flat[offs[j]:offs[j+1]] is the ordered visit list for unibin j
    (pigeonhole-filtered candidates sorted by hit count descending with
    stable first-touch tie order, then the BadList). Unibins with
    full[j] = True have empty segments and are covered by the full scan.
    """
    flat: np.ndarray       # concatenated clump ids
    offs: np.ndarray       # [n+1]
    full: np.ndarray       # [n] bool
    # sound per-unit prefilter (see accel.build_unit_index); pairs for
    # `filtered` unibins are evaluated only if their key is in
    # `pass_keys` or the unit belongs to a BadList clump
    pass_keys: np.ndarray | None = None   # sorted j*tot_units+unitpos
    filtered: np.ndarray | None = None    # [n] bool
    bad_clump: np.ndarray | None = None   # [n_clumps] bool
    # bunch-level candidate lists (pre member-filter), for inline-order
    # reporting: bunch g's list = bflat[boffs[g]:boffs[g+1]] + BadList
    bflat: np.ndarray | None = None
    boffs: np.ndarray | None = None
    qbunch: int = 1
    bad_list: np.ndarray | None = None

    def get(self, j: int):
        if self.full[j]:
            return None
        return self.flat[int(self.offs[j]): int(self.offs[j + 1])]


@dataclasses.dataclass
class SparseED:
    """Phase-A results: sparse pair EDs + dense block for full-scan rows."""
    pj: np.ndarray         # [P] unibin row per pair
    pp: np.ndarray         # [P] sorted-unit position per pair
    pe: np.ndarray         # [P] int64 min ED (<=255); None while deferred
    full_rows: np.ndarray  # unibins covered by the dense block
    ed_full: np.ndarray    # [len(full_rows), tot_units] uint8
    pending: list | None = None   # deferred (part, device result) chunks
    plast: np.ndarray | None = None  # [P] last best column (padded coords)
    pfirst: np.ndarray | None = None  # [P] first best column (padded coords)

    def materialize(self):
        """Sync deferred phase-A device chunks into pe, fetching every
        chunk's output with ONE jax.device_get."""
        if self.pending is not None:
            self.pe = np.full(len(self.pj), 255, dtype=np.int64)
            self.plast = np.full(len(self.pj), -1, dtype=np.int64)
            self.pfirst = np.full(len(self.pj), -1, dtype=np.int64)
            host = devtime.fetch([res for _, res in self.pending])
            for (part, _), h in zip(self.pending, host):
                if h.ndim == 2:       # packed [3, B] (ed, first, last)
                    self.pe[part] = h[0][: len(part)]
                    self.pfirst[part] = h[1][: len(part)]
                    self.plast[part] = h[2][: len(part)]
                else:
                    self.pe[part] = h[: len(part)]
            np.minimum(self.pe, 255, out=self.pe)
            self.pending = None
        return self

    def lookup_cols(self, juni, refpos, tot_units: int):
        """(first, last) best columns per (unibin, unit) winner; -1 if
        unknown (full-scan rows have no per-pair column record)."""
        first = np.full(len(juni), -1, dtype=np.int64)
        last = np.full(len(juni), -1, dtype=np.int64)
        if self.plast is None or not len(self.pj):
            return first, last
        keys = self.pj * tot_units + self.pp
        so = np.argsort(keys)
        ks = keys[so]
        want = juni * tot_units + refpos
        loc = np.searchsorted(ks, want)
        np.minimum(loc, len(ks) - 1, out=loc)
        hit = ks[loc] == want
        last[hit] = self.plast[so][loc[hit]]
        if self.pfirst is not None:
            first[hit] = self.pfirst[so][loc[hit]]
        return first, last

    def lookup_last(self, juni, refpos, tot_units: int):
        """Last-best-column per (unibin, unit) winner; -1 if unknown."""
        return self.lookup_cols(juni, refpos, tot_units)[1]


def default_qbunch(n: int, threads: int) -> int:
    """QBUNCH = newUniqQ/(threads*128), clamped to [1, 16]
    (burst.c:4019-4021)."""
    qbunch = n // (max(1, threads) * 128)
    return max(1, min(16, qbunch))


def bunch_thresholds(qd: QueryData, b1: int, k: int, qbunch: int,
                     do_heur: bool):
    """Pigeonhole thresholds per unibin/bunch (burst.c:4091-4095,
    4163-4168): returns (mm_bunch, mm_inner, n_bunches)."""
    lns = qd.lens[qd.six[:b1]].astype(np.int64)
    errs = qd.ed[qd.six[:b1]].astype(np.int64)
    kload = errs * k + k
    mm_member = np.where(kload < lns, lns - kload, 0)
    if do_heur:
        mm_member = np.maximum(mm_member, (lns >> 4) + 1)
    mm_inner = np.where(kload < lns, lns - kload, 1)
    n_bunches = (b1 + qbunch - 1) // qbunch
    mm_bunch = np.full(n_bunches, 1 << 60, dtype=np.int64)
    if b1:
        np.minimum.at(mm_bunch, np.arange(b1) // qbunch, mm_member)
    return mm_bunch, mm_inner, n_bunches


def _clear_row_words(qd: QueryData, r0: int, r1: int, k: int,
                     qidx_parts: list, word_parts: list) -> None:
    """Rolling k-mer words of the clear (pure-ACGT) unibin rows
    [r0, r1), appended as (row-index, word) column pairs."""
    if r1 <= r0:
        return
    qmat, qlens_all, _ = _query_matrix(qd)
    clear = np.arange(r0, r1)
    lens_c = qlens_all[clear]
    pw = (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
    for ln in np.unique(lens_c):
        rows = clear[lens_c == ln]
        if ln < k:
            continue
        sub = qmat[rows, :ln].astype(np.int64) - 1
        nwin = ln - k + 1
        words = np.zeros((len(rows), nwin), dtype=np.int64)
        for t in range(k):                       # k passes, no 3-D temp
            words += sub[:, t: t + nwin] * pw[t]
        qidx_parts.append(np.repeat(rows, nwin))
        word_parts.append(words.ravel())


def _bunch_words_padded(qd: QueryData, r0: int, b1: int, qbunch: int,
                        k: int):
    """Per-bunch deduped word lists with MAX-multiplicity weights for
    the fully-clear bunches covering rows [r0, b1) (the reference's
    shared bunch scour, burst.c:4096-4119), packed left into
    (wmat [nB, T] int32, wgt [nB, T] int32, nwords [nB]) -- or None
    when no row yields a word."""
    qp, wp = [], []
    _clear_row_words(qd, r0, b1, k, qp, wp)
    if not qp:
        return None
    qidx = np.concatenate(qp)
    words = np.concatenate(wp)
    span = np.int64(1) << np.int64(2 * k)
    ukey, mult = np.unique(qidx * span + words, return_counts=True)
    ub = (ukey // span - r0) // qbunch
    uw = ukey % span
    bkey = ub * span + uw
    bso = np.argsort(bkey, kind="stable")
    bks = bkey[bso]
    bhead = np.empty(len(bks), dtype=bool)
    bhead[0] = True
    np.not_equal(bks[1:], bks[:-1], out=bhead[1:])
    bgid = np.cumsum(bhead) - 1
    bmax = np.zeros(int(bgid[-1]) + 1, dtype=np.int64)
    np.maximum.at(bmax, bgid, mult[bso])
    gw = (bks[bhead] % span).astype(np.int64)
    gb = (bks[bhead] // span).astype(np.int64)
    nB = -(-(b1 - r0) // qbunch)
    nwords = np.bincount(gb, minlength=nB).astype(np.int32)
    T = int(nwords.max())
    wmat = np.zeros((nB, T), dtype=np.int32)
    wgt = np.ones((nB, T), dtype=np.int32)
    col = np.arange(len(gw)) - np.repeat(
        np.concatenate(([0], np.cumsum(nwords)))[:-1].astype(np.int64),
        nwords)
    wmat[gb, col] = gw.astype(np.int32)
    wgt[gb, col] = np.minimum(bmax, 0x7FFFFFFF).astype(np.int32)
    return wmat, wgt, nwords


def bunch_word_multiset(qd: QueryData, acc, b0: int, b1: int,
                        qbunch: int, k: int):
    """Per-(bunch, word) k-mer multiset of the accelerator-eligible
    unibins (burst.c:4096-4119): returns (bwords, bb, bmax, uq, uw,
    mult) -- the deduped bunch word list with MAX-multiplicity weights,
    plus the per-(unibin, word) multiset behind it -- or None when no
    unibin yields a word. Depends only on the (replicated) queries, so
    every DB-shard host computes the identical list."""
    from .accel import query_words

    qidx_parts, word_parts = [], []
    # ambiguous unibins: per-query expansion (few)
    for j in range(b0):
        words = query_words(qd.seqs[j], k, acc.z, ambiguous=True)
        if words.size:
            qidx_parts.append(np.full(words.size, j, dtype=np.int64))
            word_parts.append(words)
    # clear unibins: vectorized rolling k-mers, grouped by length
    _clear_row_words(qd, b0, b1, k, qidx_parts, word_parts)
    if not qidx_parts:
        return None
    qidx = np.concatenate(qidx_parts)
    words = np.concatenate(word_parts)
    span = np.int64(1) << np.int64(2 * k)
    ukey, mult = np.unique(qidx * span + words, return_counts=True)
    uq = ukey // span
    uw = ukey % span
    # per (bunch, word): weight = MAX multiplicity over bunch members
    if qbunch == 1:
        bwords, bb, bmax = uw, uq, mult.astype(np.int64)
    else:
        ub = uq // qbunch
        bkey = ub * span + uw
        bso = np.argsort(bkey, kind="stable")
        bks = bkey[bso]
        bhead = np.empty(len(bks), dtype=bool)
        bhead[0] = True
        np.not_equal(bks[1:], bks[:-1], out=bhead[1:])
        bgid = np.cumsum(bhead) - 1
        bmax = np.zeros(int(bgid[-1]) + 1, dtype=np.int64)
        np.maximum.at(bmax, bgid, mult[bso])
        bwords = (bks[bhead] % span).astype(np.int64)
        bb = (bks[bhead] // span).astype(np.int64)
    return bwords, bb, bmax, uq, uw, mult


def scour_raw(acc, bwords, bb, bmax, n_clumps: int):
    """Scour acc's postings for the bunch word list: per-candidate
    (bunch, clump, hits, first-word) tuples, or None when no posting
    matches. `acc` may be a per-host shard (postings filtered to a
    clump range): candidates for a clump are computed entirely on the
    host owning it, so concatenating per-host results reproduces the
    single-process candidate set exactly."""
    starts, seg = acc.csr.lookup(bwords)
    total = int(seg.sum())
    if total == 0:
        return None
    base = np.repeat(starts - np.concatenate(
        ([0], np.cumsum(seg)[:-1])), seg)
    flat = base + np.arange(total)
    cl = acc.ids[flat].astype(np.int64)
    brep = np.repeat(bb, seg)
    wgt = np.repeat(bmax, seg)
    wrd = np.repeat(bwords, seg)
    pkey = brep * n_clumps + cl
    # group-by via one stable argsort (first occurrence = group head)
    so = np.argsort(pkey, kind="stable")
    ps = pkey[so]
    head = np.empty(len(ps), dtype=bool)
    head[0] = True
    np.not_equal(ps[1:], ps[:-1], out=head[1:])
    u2 = ps[head]
    gid = np.cumsum(head) - 1
    hits = np.bincount(gid, weights=wgt[so].astype(np.float64)
                       ).astype(np.int64)
    first = so[np.nonzero(head)[0]]
    np.minimum(hits, 0xFFFF, out=hits)
    pb = (u2 // n_clumps).astype(np.int64)   # bunch id per candidate
    pc = (u2 % n_clumps).astype(np.int64)
    # first-occurrence k-mer of each candidate: the scour stream walks
    # words ascending per bunch with clump-ascending postings, so
    # ordering by (fw, clump) equals ordering by stream position -- and
    # unlike the position it is comparable across per-host shards
    fw = wrd[first]
    return pb, pc, hits, fw


def assemble_accel_visits(n: int, b0: int, b1: int, qbunch: int,
                          n_bunches: int, bad_arr, full,
                          pb, pc, hits, fw, mm_bunch,
                          mm_inner) -> Visits:
    """Candidate tuples -> Visits: pigeonhole filter, reference visit
    order (hits desc, first-occurrence asc; burst.c:4120-4130), member
    expansion with the per-member inner skip, BadList append. Pure
    host-side assembly shared by the single-process path and the
    multi-host merge (which concatenates per-host scour_raw results
    first)."""
    nb = len(bad_arr)
    keep = hits > mm_bunch[pb]
    kb = pb[keep]
    srt = np.lexsort((pc[keep], fw[keep], -hits[keep], kb))
    kb = kb[srt]
    kc = pc[keep][srt]
    kh = hits[keep][srt]
    # expand bunch candidate lists to members, applying the per-member
    # inner skip (bunch hits vs the member's threshold)
    cands_per_b = np.bincount(kb, minlength=n_bunches)
    bstart = np.concatenate(([0], np.cumsum(cands_per_b)))
    memb = np.arange(b1)
    mb = memb // qbunch
    reps = cands_per_b[mb]
    mrep = np.repeat(memb, reps)                 # member per expanded cand
    total_e = int(reps.sum())
    csr = np.concatenate(([0], np.cumsum(reps)))[:-1]
    src = (np.arange(total_e) - np.repeat(csr, reps)
           + np.repeat(bstart[mb], reps))
    kc_m = kc[src]
    ok = kh[src] > mm_inner[mrep]
    mrep, kc_m = mrep[ok], kc_m[ok]
    cands_per_q = np.bincount(mrep, minlength=b1)
    offs = np.zeros(n + 1, dtype=np.int64)
    offs[1: b1 + 1] = np.cumsum(cands_per_q + nb)
    offs[b1 + 1:] = offs[b1]
    out = np.empty(int(offs[b1]), dtype=np.int64)
    csum = np.concatenate(([0], np.cumsum(cands_per_q)))
    out[offs[mrep] + (np.arange(len(mrep)) - csum[mrep])] = kc_m
    if nb:
        dst = (offs[:b1, None] + cands_per_q[:, None] +
               np.arange(nb)[None, :]).ravel()
        out[dst] = np.tile(bad_arr, b1)
    boffs = np.zeros(n_bunches + 1, dtype=np.int64)
    boffs[1:] = np.cumsum(cands_per_b)
    return Visits(flat=out, offs=offs, full=full, bflat=kc, boffs=boffs,
                  qbunch=qbunch, bad_list=bad_arr)


def accel_candidates(qd: QueryData, rd: RefData, acc, qbins: np.ndarray,
                     do_heur: bool = False, threads: int = 1,
                     qbunch: int | None = None,
                     dev_scour: bool | None = None,
                     skip_ambig: bool = False) -> Visits:
    """Build per-unibin candidate visit lists (vectorized host pass).

    The reference scans QBUNCH unibins per task (burst.c:4018-4021,
    QBUNCH = newUniqQ/(threads*128) clamped to [1,16]): the bunch
    shares one scour -- per word the count contribution is the MAX
    multiplicity across the bunch (postScour's run logic,
    burst.c:3258-3284) -- one candidate list filtered by the bunch's
    minimum threshold, and one visit order. The per-member threshold
    only skips evaluations (burst.c:4163-4168). Thread count changes
    QBUNCH and therefore row order; -t 1 is the canonical comparison.
    """
    from .accel import query_words

    k = acc.k
    n = len(qd.seqs)
    n_clumps = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    bad_arr = np.asarray(acc.bad, dtype=np.int64)
    b0, b1 = int(qbins[0]), int(qbins[1])
    full = np.ones(n, dtype=bool)
    full[:b1] = False
    if skip_ambig:
        # -sa at align time: BadList second pass and the full-scan
        # fallback are both skipped; bad-bin unibins drop silently
        # (burst.c:4047, 4322)
        bad_arr = bad_arr[:0]
        full[:] = False
    nb = len(bad_arr)

    def _bad_only() -> Visits:
        offs = np.zeros(n + 1, dtype=np.int64)
        offs[1: b1 + 1] = np.arange(1, b1 + 1) * nb
        offs[b1 + 1:] = b1 * nb
        return Visits(flat=np.tile(bad_arr, b1), offs=offs, full=full)

    if qbunch is None:
        qbunch = default_qbunch(n, threads)
    mm_bunch, mm_inner, n_bunches = bunch_thresholds(qd, b1, k, qbunch,
                                                     do_heur)

    if b1:
        vis = _accel_candidates_native(
            qd, rd, acc, b0, b1, qbunch, k, mm_bunch, mm_inner, do_heur,
            bad_arr, full, n_clumps, _bad_only, dev_scour)
        if vis is not None:
            return vis

    bw = bunch_word_multiset(qd, acc, b0, b1, qbunch, k)
    if bw is None:
        return _bad_only()
    bwords, bb, bmax, uq, uw, mult = bw
    raw = scour_raw(acc, bwords, bb, bmax, n_clumps)
    if raw is None:
        return _bad_only()
    pb, pc, hits, fw = raw

    vis = assemble_accel_visits(n, b0, b1, qbunch, n_bunches, bad_arr,
                                full, pb, pc, hits, fw, mm_bunch,
                                mm_inner)

    # sound per-unit prefilter for clear unibins (q-gram pigeonhole at
    # unit granularity; cannot drop any winner -- see build_unit_index).
    # Disabled under -hr whose clump-level cut is already non-optimal:
    # lane-level pruning there could change the (heuristic) output.
    if not do_heur and rd_acc_unit_index(rd, acc):
        clear_q = (uq >= b0)       # ambiguous unibins stay unfiltered
        ustarts, useg = acc.u_csr.lookup(uw)
        useg = np.where(clear_q, useg, 0)
        totalu = int(useg.sum())
        filtered = np.zeros(n, dtype=bool)
        filtered[b0:b1] = True
        if totalu:
            ubase = np.repeat(ustarts - np.concatenate(
                ([0], np.cumsum(useg)[:-1])), useg)
            uflat = ubase + np.arange(totalu)
            up = acc.u_csr.ids[uflat].astype(np.int64)
            uqrep = np.repeat(uq, useg)
            uwgt = np.repeat(mult, useg)
            pkey2 = uqrep * rd.tot_units + up
            so2 = np.argsort(pkey2, kind="stable")
            ps2 = pkey2[so2]
            head2 = np.empty(len(ps2), dtype=bool)
            head2[0] = True
            np.not_equal(ps2[1:], ps2[:-1], out=head2[1:])
            gid2 = np.cumsum(head2) - 1
            uhits = np.bincount(gid2, weights=uwgt[so2].astype(np.float64)
                                ).astype(np.int64)
            ukeys = ps2[head2]
            uq2 = ukeys // rd.tot_units
            passing = uhits > mm_inner[uq2]
            vis.pass_keys = ukeys[passing]
        else:
            vis.pass_keys = np.zeros(0, dtype=np.int64)
        vis.filtered = filtered
        bad_clump = np.zeros(n_clumps, dtype=bool)
        bad_clump[bad_arr] = True
        vis.bad_clump = bad_clump
    return vis


def _accel_candidates_native(qd: QueryData, rd: RefData, acc, b0: int,
                             b1: int, qbunch: int, k: int,
                             mm_bunch, mm_inner, do_heur: bool,
                             bad_arr, full, n_clumps: int, bad_only,
                             dev_scour: bool | None = None):
    """C++/OpenMP scour path (native/burst_host.cpp): same semantics as
    the numpy pass in accel_candidates, several times faster. Returns
    None when the native library is unavailable (numpy path runs)."""
    from .native import load_host, scour_native

    if load_host() is None:
        return None
    qmat, qlens_all, _ = _query_matrix(qd)
    aq_off, aqw, aqm, has_words = _ambig_word_lists(qd, b0, k, acc.z)
    if b1 > b0 and bool((qlens_all[b0:b1] >= k).any()):
        has_words = True
    if not has_words:
        return bad_only()
    do_unit = not do_heur and rd_acc_unit_index(rd, acc)
    res = None
    if do_unit and _use_device_scour(dev_scour):
        res = _scour_device_rows(qd, rd, acc, b0, b1, qbunch, k,
                                 mm_bunch, mm_inner, qmat, qlens_all,
                                 aq_off, aqw, aqm, n_clumps)
    if res is None:
        res = scour_native(qmat, qlens_all, b0, b1, qbunch, k, aq_off,
                           aqw, aqm, acc.csr, n_clumps, mm_bunch,
                           mm_inner,
                           u_csr=acc.u_csr if do_unit else None,
                           tot_units=rd.tot_units, vecsz=VECSZ)
    if res is None:
        return None
    return _assemble_visits(qd, res, b0, b1, qbunch, bad_arr, full,
                            n_clumps, do_unit)


def _assemble_visits(qd, res, b0: int, b1: int, qbunch: int, bad_arr,
                     full, n_clumps: int, do_unit: bool) -> "Visits":
    """Visits CSR from a scour result tuple (shared by the native,
    device, and fused paths)."""
    n = len(qd.seqs)
    nb = len(bad_arr)
    kc, kh, bcnt, mflat, mcnt, ukeys = res

    offs = np.zeros(n + 1, dtype=np.int64)
    offs[1: b1 + 1] = np.cumsum(mcnt + nb)
    offs[b1 + 1:] = offs[b1]
    out = np.empty(int(offs[b1]), dtype=np.int64)
    nm = len(mflat)
    if nm != int(mcnt.sum()):
        raise RuntimeError(
            f"scour result inconsistent: len(mflat)={nm} != "
            f"sum(mcnt)={int(mcnt.sum())} -- concurrent scour calls "
            "clobbering shared result state?")
    if nm:
        csum = np.concatenate(([0], np.cumsum(mcnt)[:-1]))
        dst = np.repeat(offs[:b1], mcnt) + \
            (np.arange(nm) - np.repeat(csum, mcnt))
        out[dst] = mflat
    if nb:
        dstb = (offs[:b1, None] + mcnt[:, None] +
                np.arange(nb)[None, :]).ravel()
        out[dstb] = np.tile(bad_arr, b1)
    n_bunches = (b1 + qbunch - 1) // qbunch
    boffs = np.zeros(n_bunches + 1, dtype=np.int64)
    boffs[1:] = np.cumsum(bcnt)
    vis = Visits(flat=out, offs=offs, full=full, bflat=kc, boffs=boffs,
                 qbunch=qbunch, bad_list=bad_arr)

    if do_unit:
        vis.pass_keys = ukeys
        filtered = np.zeros(n, dtype=bool)
        filtered[b0:b1] = True
        vis.filtered = filtered
        bad_clump = np.zeros(n_clumps, dtype=bool)
        bad_clump[bad_arr] = True
        vis.bad_clump = bad_clump
    return vis


def _inject_device_peq(qd, b0: int, b1: int, smat: np.ndarray,
                       smat_dev, W: int, fetch) -> bool:
    """Seed the phase-B Peq device cache from the fused scan's batch
    matrix. Only when the scan covers every row (no ambiguous or
    full-scan rows) and they all share one Myers word count -- the
    general case keeps the host build."""
    from .kernels.scour_device import _peq_pow2_jit

    nj = len(qd.seqs)
    if b0 != 0 or b1 != nj:
        return False
    _, _, qw = _query_matrix(qd)
    if nj == 0 or not bool((qw == W).all()):
        return False
    key = (W, smat.tobytes())
    cache = getattr(qd, "_peqdev", None)
    if cache is None:
        cache = {}
        qd._peqdev = cache
    if key in cache:
        return True
    qp_d, lp_d = fetch.batch_dev
    pow2 = max(_pow2_ceil(nj), qp_d.shape[0])
    peq_dev = _peq_pow2_jit(qp_d, lp_d, smat_dev, W=W, POW2=pow2)
    cache[key] = (np.arange(nj, dtype=np.int64), peq_dev)
    return True


def _ambig_word_lists(qd, b0: int, k: int, z: int):
    """Ambiguous unibins' expanded unique words + multiplicities."""
    from .accel import query_words

    aq_off = np.zeros(b0 + 1, np.int64)
    aqw_parts, aqm_parts = [], []
    has_words = False
    for j in range(b0):
        words = query_words(qd.seqs[j], k, z, ambiguous=True)
        if words.size:
            uw_, um_ = np.unique(words, return_counts=True)
            aqw_parts.append(uw_.astype(np.int64))
            aqm_parts.append(um_.astype(np.int64))
            aq_off[j + 1] = aq_off[j] + len(uw_)
            has_words = True
        else:
            aq_off[j + 1] = aq_off[j]
    aqw = np.concatenate(aqw_parts) if aqw_parts \
        else np.zeros(0, np.int64)
    aqm = np.concatenate(aqm_parts) if aqm_parts \
        else np.zeros(0, np.int64)
    return aq_off, aqw, aqm, has_words


def _use_device_scour(override: bool | None = None) -> bool:
    """Device scour policy: per-call override wins, then
    BURST_TPU_DEV_SCOUR=1/0, then on iff the default JAX backend is an
    accelerator. The all-host mode (devtime.device_ok) vetoes
    everything -- including overrides."""
    import os
    if not devtime.device_ok():
        return False
    if override is not None:
        return override
    v = os.environ.get("BURST_TPU_DEV_SCOUR")
    if v is not None:
        return v not in ("0", "", "off")
    import jax
    return jax.default_backend() != "cpu"


def _scour_device_rows(qd, rd, acc, b0, b1, qbunch, k, mm_bunch,
                       mm_inner, qmat, qlens_all, aq_off, aqw, aqm,
                       n_clumps, fused_ctx=None):
    """Run the clear rows [b0, b1) through the device scour and merge
    with a host scour of the ambiguous rows [0, b0). Returns the same
    (bflat, bhits, bcnt, mflat, mcnt, ukeys) tuple as scour_native --
    with fused_ctx, a (tuple, pairinfo) pair where pairinfo carries the
    clear rows' device-aligned pairs -- or None when preconditions fail
    (caller uses the host path).

    The native walk and the device slot expansion produce identical hit
    counts and candidate orderings (see kernels/scour_device docstring);
    order parity additionally needs ascending clump-grouped unit
    postings -- the same precondition as the native fast path.
    """
    from .kernels import scour_device
    from .native import scour_native, _unit_ids_clump_grouped

    if b1 <= b0:
        return None
    if qbunch != 1:
        if fused_ctx is not None:
            return None                 # fused chain is QBUNCH=1-only
        return _scour_device_bunches(qd, rd, acc, b0, b1, qbunch, k,
                                     mm_bunch, mm_inner, qmat,
                                     qlens_all, aq_off, aqw, aqm,
                                     n_clumps)
    if not _unit_ids_clump_grouped(acc.u_csr, VECSZ):
        return None
    tabs = scour_device.get_tables(acc)
    if tabs is None:
        return None
    tot_units = rd.tot_units
    nc = b1 - b0
    lens_c = qlens_all[b0:b1]
    mm_m = mm_bunch[b0:b1]             # qbunch == 1: bunch == member
    mm_i = mm_inner[b0:b1]
    if fused_ctx is not None:
        smat_np, smat_dev, tiles_dev, W = fused_ctx
        fetch = scour_device.scour_align_rows(
            qmat[b0:b1], lens_c, k, mm_m, mm_i, tabs, n_clumps,
            tot_units, smat_dev, tiles_dev, W)
        # phase B rescores winners against device Peq planes; when the
        # batch is one clear W bucket they build straight from the
        # matrix just uploaded (no host build/transfer)
        if not _inject_device_peq(qd, b0, b1, smat_np, smat_dev, W,
                                  fetch):
            prefetch_query_planes(qd, smat_np)
    else:
        fetch = scour_device.scour_rows(
            qmat[b0:b1], lens_c, k, mm_m, mm_i, tabs, n_clumps,
            tot_units, defer=True)
    # ambiguous rows on the host while the device runs
    if b0 > 0:
        amb = scour_native(qmat, qlens_all, b0, b0, 1, k, aq_off, aqw,
                           aqm, acc.csr, n_clumps, mm_bunch[:b0],
                           mm_inner[:b0], u_csr=acc.u_csr,
                           tot_units=tot_units, vecsz=VECSZ)
        if amb is None:
            return None
    else:
        z = np.zeros(0, np.int64)
        amb = (z, z, z, z, z, z)
    try:
        dev = fetch()
    except scour_device.ScourOverflow:
        return None
    ov = dev["ov"]
    lj = dev["cj"]                     # local (0-based) clear row
    lcl = dev["ccl"]
    chits = dev["chits"]
    cminw = dev["cminw"]
    if ov.any():
        # exact host re-scour of overflowing rows, spliced back in
        rows = np.nonzero(ov)[0]
        sub = np.ascontiguousarray(qmat[b0 + rows])
        zb = np.zeros(1, np.int64)
        sres = scour_native(sub, lens_c[rows], 0, len(rows), 1, k,
                            np.zeros(len(rows) + 1, np.int64), zb, zb,
                            acc.csr, n_clumps, mm_m[rows], mm_i[rows],
                            u_csr=acc.u_csr, tot_units=tot_units,
                            vecsz=VECSZ)
        if sres is None:
            return None
        sbf, sbh, sbc, smf, smc, suk = sres
        keep = ~ov[lj]
        lj, lcl, chits, cminw = (lj[keep], lcl[keep], chits[keep],
                                 cminw[keep])
        # candidate tuples for re-scoured rows, in their (hits desc,
        # touch asc) order; minw encodes the native rank so the final
        # lexsort preserves it exactly
        sj = np.repeat(rows.astype(np.int64), sbc)
        srank = np.arange(len(sbf), dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(sbc)[:-1])), sbc)
        lj = np.concatenate([lj, sj])
        lcl = np.concatenate([lcl, sbf])
        chits = np.concatenate([chits, sbh])
        cminw = np.concatenate([cminw, -(1 << 40) + srank])
        # native sub-call keys are localrow*tot_units + u
        suk_g = rows[suk // tot_units].astype(np.int64) * tot_units \
            + suk % tot_units
    # order candidates per row: hits desc, first-touch (min word) asc,
    # clump asc -- identical to the native walk's insertion order
    srt = np.lexsort((lcl, cminw, -chits, lj))
    lj, lcl, chits = lj[srt], lcl[srt], chits[srt]
    bcnt_c = np.bincount(lj, minlength=nc).astype(np.int64)
    mkeep = chits > mm_i[lj]
    mcnt_c = np.bincount(lj[mkeep], minlength=nc).astype(np.int64)
    ukeys_c = dev["ukeys"] + np.int64(b0) * tot_units
    if ov.any():
        keepu = ~ov[dev["ukeys"] // tot_units]
        ukeys_c = ukeys_c[keepu]
        ukeys_c = np.sort(np.concatenate(
            [ukeys_c, suk_g + np.int64(b0) * tot_units]))
    abf, abh, abc, amf, amc, auk = amb
    bflat = np.concatenate([abf, lcl])
    bhits = np.concatenate([abh, chits])
    bcnt = np.concatenate([abc, bcnt_c])
    mflat = np.concatenate([amf, lcl[mkeep]])
    mcnt = np.concatenate([amc, mcnt_c])
    if auk is None:
        auk = np.zeros(0, np.int64)
    ukeys = np.concatenate([auk, ukeys_c])
    res = (bflat, bhits, bcnt, mflat, mcnt, ukeys)
    if fused_ctx is None:
        return res
    pairinfo = {
        "uj": dev["uj"] + b0,          # global unibin rows
        "uu": dev["uu"],
        "packed": np.stack([dev["ped"], dev["pfirst"], dev["plast"]]),
        "ov_rows": np.nonzero(ov)[0] + b0,
    }
    return res, pairinfo


def _scour_device_bunches(qd, rd, acc, b0, b1, qbunch, k, mm_bunch,
                          mm_inner, qmat, qlens_all, aq_off, aqw, aqm,
                          n_clumps):
    """QBUNCH>1 device scour: two overlapped dispatches reproduce the
    native bunch walk bit-for-bit (burst.c:4018-4136 at the reference's
    default QBUNCH up to 16).

    Dispatch A (scour_bunch_rows): one row per fully-clear bunch,
    deduped words weighted by MAX member multiplicity -> the bunch
    candidate clump lists. Dispatch B (scour_rows with the clump
    filter saturated): one row per member -> the exact per-member
    passing unit keys. Bunches containing ambiguous rows (the sorted
    prefix [0, ceil(b0/qbunch)*qbunch)) run on the host C++ scour
    while both device dispatches are in flight. Overflowing bunch rows
    re-scour on the host candidates-only; overflowing member rows
    re-run the host unit prefilter; both splice exactly."""
    from .kernels import scour_device
    from .native import scour_native, _unit_ids_clump_grouped

    g0 = -(-b0 // qbunch)              # first fully-clear bunch
    r0 = g0 * qbunch
    if r0 >= b1:
        return None
    if not _unit_ids_clump_grouped(acc.u_csr, VECSZ):
        return None
    tabs = scour_device.get_tables(acc)
    if tabs is None:
        return None
    tot_units = rd.tot_units
    bwp = _bunch_words_padded(qd, r0, b1, qbunch, k)
    if bwp is None:
        return None
    wmat, wgt, nwords = bwp
    nB = wmat.shape[0]
    nm = b1 - r0
    fetch_b = scour_device.scour_bunch_rows(
        wmat, wgt, nwords, mm_bunch[g0:],
        np.full(nB, 1 << 60, np.int64),           # no unit winners
        tabs, tot_units, defer=True)
    fetch_m = scour_device.scour_rows(
        qmat[r0:b1], qlens_all[r0:b1], k,
        np.full(nm, 1 << 60, np.int64),           # no clump winners
        mm_inner[r0:b1], tabs, n_clumps, tot_units, defer=True)
    # ambiguous rows + the straddling bunch on the host meanwhile
    if r0 > 0:
        pre = scour_native(qmat, qlens_all, b0, r0, qbunch, k, aq_off,
                           aqw, aqm, acc.csr, n_clumps, mm_bunch[:g0],
                           mm_inner[:r0], u_csr=acc.u_csr,
                           tot_units=tot_units, vecsz=VECSZ)
        if pre is None:
            return None
    else:
        z = np.zeros(0, np.int64)
        pre = (z, z, z, z, z, z)
    try:
        dev_b = fetch_b()
        dev_m = fetch_m()
    except scour_device.ScourOverflow:
        return None
    abf, abh, abc, amf, amc, auk = pre

    # bunch candidates: splice host re-scours of overflowed bunches
    gj, gcl = dev_b["cj"], dev_b["ccl"]
    ghits, gminw = dev_b["chits"], dev_b["cminw"]
    ovb = dev_b["ov"]
    if ovb.any():
        keep = ~ovb[gj]
        gj, gcl = gj[keep], gcl[keep]
        ghits, gminw = ghits[keep], gminw[keep]
        aj, acl, ah, amw = [gj], [gcl], [ghits], [gminw]
        for bg in np.nonzero(ovb)[0]:
            j_lo = r0 + int(bg) * qbunch
            j_hi = min(b1, j_lo + qbunch)
            sub = np.ascontiguousarray(qmat[j_lo:j_hi])
            zb = np.zeros(1, np.int64)
            sres = scour_native(
                sub, qlens_all[j_lo:j_hi], 0, j_hi - j_lo, qbunch, k,
                np.zeros(j_hi - j_lo + 1, np.int64), zb, zb, acc.csr,
                n_clumps, mm_bunch[g0 + bg: g0 + bg + 1],
                mm_inner[j_lo:j_hi])
            if sres is None:
                return None
            sbf, sbh = sres[0], sres[1]
            aj.append(np.full(len(sbf), bg, np.int64))
            acl.append(sbf)
            ah.append(sbh)
            # native rank encoded below the device minw range keeps
            # the (hits desc, touch asc) order through the lexsort
            amw.append(-(1 << 40) + np.arange(len(sbf), dtype=np.int64))
        gj, gcl = np.concatenate(aj), np.concatenate(acl)
        ghits, gminw = np.concatenate(ah), np.concatenate(amw)
    srt = np.lexsort((gcl, gminw, -ghits, gj))
    gj, gcl, ghits = gj[srt], gcl[srt], ghits[srt]
    bcnt_dev = np.bincount(gj, minlength=nB).astype(np.int64)

    # member expansion with the per-member inner skip (burst.c:4163-68)
    bstart = np.concatenate(([0], np.cumsum(bcnt_dev)))
    members = np.arange(r0, b1, dtype=np.int64)
    mb = (members - r0) // qbunch
    reps = bcnt_dev[mb]
    mrep = np.repeat(members, reps)
    total_e = int(reps.sum())
    csr0 = np.concatenate(([0], np.cumsum(reps)))[:-1]
    src = (np.arange(total_e, dtype=np.int64) - np.repeat(csr0, reps)
           + np.repeat(bstart[mb], reps))
    okm = ghits[src] > mm_inner[mrep]
    mflat_dev = gcl[src][okm]
    mcnt_dev = np.bincount(mrep[okm] - r0, minlength=nm).astype(np.int64)

    # member-exact unit keys; overflowed member rows re-run on host
    ovm = dev_m["ov"]
    uk = dev_m["ukeys"]
    if ovm.any():
        uk = uk[~ovm[uk // tot_units]]
        extra = [uk]
        for lr in np.nonzero(ovm)[0]:
            j = r0 + int(lr)
            sub = np.ascontiguousarray(qmat[j: j + 1])
            zb = np.zeros(1, np.int64)
            sres = scour_native(
                sub, qlens_all[j: j + 1], 0, 1, 1, k,
                np.zeros(2, np.int64), zb, zb, acc.csr, n_clumps,
                np.full(1, 1 << 60, np.int64), mm_inner[j: j + 1],
                u_csr=acc.u_csr, tot_units=tot_units, vecsz=VECSZ)
            if sres is None:
                return None
            extra.append(np.int64(lr) * tot_units + sres[5])
        uk = np.sort(np.concatenate(extra))
    ukeys_c = uk + np.int64(r0) * tot_units
    if auk is None:
        auk = np.zeros(0, np.int64)
    return (np.concatenate([abf, gcl]), np.concatenate([abh, ghits]),
            np.concatenate([abc, bcnt_dev]),
            np.concatenate([amf, mflat_dev]),
            np.concatenate([amc, mcnt_dev]),
            np.concatenate([auk, ukeys_c]))


def rd_acc_unit_index(rd: RefData, acc) -> bool:
    """Ensure the unit-granular index exists (built once per (rd, acc))."""
    from .accel import build_unit_index
    build_unit_index(rd, acc)
    return acc.u_csr is not None


def _smat_device(rd: RefData, smat: np.ndarray):
    """Device copy of the 16x16 score table (cached per content)."""
    import jax.numpy as jnp
    cache = getattr(rd, "_smatdev", None)
    if cache is None:
        cache = {}
        rd._smatdev = cache
    key = smat.tobytes()
    got = cache.get(key)
    if got is None:
        got = cache[key] = jnp.asarray(smat)
    return got


_TILES_ALL_LOCK = __import__("threading").Lock()

# Batches, and clear query rows within them, that the fused device
# chain (accel_scan_fused) has served in this process.
fused_served = {"batches": 0, "rows": 0}
_FUSED_LOCK = __import__("threading").Lock()


def _tiles_device_all(rd: RefData, pad: int = 32):
    """Packed-word device tile matrix over ALL units: row = sorted
    position, logical width = max unit length bucket + pad, 8 codes per
    u32 word (kernels.myers.pack_words_np). Returns (device words,
    logical width). Cached; locked against streaming worker threads
    racing the first build."""
    import jax.numpy as jnp
    got = getattr(rd, "_tilealldev", None)
    if got is not None:
        return got
    with _TILES_ALL_LOCK:
        got = getattr(rd, "_tilealldev", None)
        if got is not None:
            return got
        lbmax = int(_unit_lb(rd).max()) if rd.tot_units else 64
        npad = _pow2_ceil(max(1, rd.tot_units))
        width = -(-(lbmax + pad) // 2) * 2
        mat = np.zeros((npad, width), dtype=np.uint8)
        # chunked native memcpy (the per-row Python loop costs minutes
        # at production unit counts; see _fill_rows)
        _fill_rows(mat, rd, np.arange(rd.tot_units, dtype=np.int64))
        got = rd._tilealldev = (
            jnp.asarray(myers.pack_words_np(mat)), width)
    return got


def accel_scan_fused(qd: QueryData, rd: RefData, acc,
                     qbins: np.ndarray, smat: np.ndarray | None = None,
                     qbunch: int | None = None, threads: int = 1,
                     dev_scour: bool | None = None,
                     skip_ambig: bool = False):
    """Fused accelerator scan: device scour + phase-A pair alignment in
    ONE dispatch chain, one fetch. Returns (visits, sed) -- drop-in for
    accel_candidates + compute_ed_matrix_accel(defer=True) -- or None
    when preconditions fail (callers run the two-step path).

    Preconditions: QBUNCH == 1 (the reference's many-thread regime,
    burst.c:4019-4021), non-xalpha, a single tile length bucket, and
    the unit index with clump-grouped postings. k up to 15 is
    supported: k <= 13 uses the dense device rank table, 14/15 the
    sorted-word binary search (ScourTables; fused-path equality at
    k=15 covered by test_fused_scan_matches_two_step_k15). Ambiguous
    rows, BadList clump units, device-overflow rows, and full-scan rows
    are still evaluated through the host-dispatch path, overlapping the
    device chain.
    """
    import os

    from . import native
    from .native import _unit_ids_clump_grouped

    if os.environ.get("BURST_TPU_FUSED", "1") in ("0", "", "off"):
        return None
    if not _use_device_scour(dev_scour) or getattr(qd, "xalpha", False):
        return None
    k = acc.k
    n = len(qd.seqs)
    b0, b1 = int(qbins[0]), int(qbins[1])
    if qbunch is None:
        qbunch = min(16, max(1, n // (max(1, threads) * 128)))
    if qbunch != 1 or b1 <= b0:
        return None
    if native.load_host() is None:
        if native.host_build_error() is not None:
            raise RuntimeError("the device path needs the native host "
                               "library, whose build failed:\n"
                               + native.host_build_error())
        return None                      # BURST_TPU_NO_NATIVE
    if not rd_acc_unit_index(rd, acc) or \
            not _unit_ids_clump_grouped(acc.u_csr, VECSZ):
        return None
    from .kernels import scour_device
    tabs = scour_device.get_tables(acc)
    if tabs is None:
        return None
    if smat is None:
        smat = score_matrix()
    tot_units = rd.tot_units
    n_clumps = tot_units // VECSZ + (1 if tot_units % VECSZ else 0)
    bad_arr = np.asarray(acc.bad, dtype=np.int64)
    full = np.ones(n, dtype=bool)
    full[:b1] = False
    if skip_ambig:
        # -sa align semantics (burst.c:4047, 4322): no BadList pass,
        # no full-scan fallback; bad-bin unibins drop silently
        bad_arr = bad_arr[:0]
        full[:] = False
    qmat, qlens_all, qw_all = _query_matrix(qd)
    if not bool((qlens_all[b0:b1] >= k).any()):
        return None                      # degenerate; two-step path
    W = int(qw_all[:b1].max())
    lns = qd.lens[qd.six[:b1]].astype(np.int64)
    errs = qd.ed[qd.six[:b1]].astype(np.int64)
    kload = errs * k + k
    mm_bunch = np.where(kload < lns, lns - kload, 0)
    mm_inner = np.where(kload < lns, lns - kload, 1)
    aq_off, aqw, aqm, _ = _ambig_word_lists(qd, b0, k, acc.z)
    lbmax = int(_unit_lb(rd).max()) if tot_units else 64
    if _pow2_ceil(max(1, tot_units)) * (-(-(lbmax + 32) // 8) * 4) > \
            _tile_budget_bytes():
        return None  # DB over the device budget: two-step path streams
    smat_dev = _smat_device(rd, smat)
    tiles_words, lp_all = _tiles_device_all(rd)
    out = _scour_device_rows(
        qd, rd, acc, b0, b1, 1, k, mm_bunch, mm_inner, qmat, qlens_all,
        aq_off, aqw, aqm, n_clumps,
        fused_ctx=(smat, smat_dev, (tiles_words, lp_all), W))
    if out is None:
        return None
    res, pinfo = out
    with _FUSED_LOCK:
        fused_served["batches"] += 1
        fused_served["rows"] += b1 - b0 - len(pinfo["ov_rows"])
    vis = _assemble_visits(qd, res, b0, b1, 1, bad_arr, full, n_clumps,
                           True)

    # host-dispatch pairs: ambiguous rows (every lane of their visit
    # lists), BadList units for clear rows, and pass-units of rows the
    # device overflowed (host re-scoured)
    hp_j, hp_p = [], []
    if b0:
        nvis = vis.offs[1: b0 + 1] - vis.offs[:b0]
        qrep = np.repeat(np.arange(b0, dtype=np.int64), nvis)
        ps = (vis.flat[: vis.offs[b0], None] * VECSZ
              + np.arange(VECSZ)).ravel()
        pjj = np.repeat(qrep, VECSZ)
        m = ps < tot_units
        hp_j.append(pjj[m])
        hp_p.append(ps[m])
    if len(bad_arr):
        units_b = (bad_arr[:, None] * VECSZ + np.arange(VECSZ)).ravel()
        units_b = units_b[units_b < tot_units]
        rows_c = np.arange(b0, b1, dtype=np.int64)
        hp_j.append(np.repeat(rows_c, len(units_b)))
        hp_p.append(np.tile(units_b, len(rows_c)))
    if len(pinfo["ov_rows"]) and vis.pass_keys is not None:
        rowk = vis.pass_keys // tot_units
        inov = np.isin(rowk, pinfo["ov_rows"])
        hp_j.append(rowk[inov])
        hp_p.append(vis.pass_keys[inov] % tot_units)
    pj_h = np.concatenate(hp_j) if hp_j else np.zeros(0, np.int64)
    pp_h = np.concatenate(hp_p) if hp_p else np.zeros(0, np.int64)
    pending = _pairs_min_ed(qd, rd, pj_h, pp_h, smat, defer=True) \
        if len(pj_h) else []

    full_rows = np.nonzero(vis.full)[0]
    if len(full_rows):
        sub = _subset_qd(qd, list(full_rows))
        ed_full = compute_ed_matrix(sub, rd, smat)
    else:
        ed_full = np.zeros((0, tot_units), dtype=np.uint8)

    pj = np.concatenate([pj_h, pinfo["uj"]])
    pp = np.concatenate([pp_h, pinfo["uu"]])
    # device results enter as a pre-resolved chunk (device_get on a
    # numpy array is the identity)
    nh = len(pj_h)
    if len(pinfo["uj"]):
        pending = list(pending) + [
            (np.arange(nh, nh + len(pinfo["uj"])), pinfo["packed"])]
    sed = SparseED(pj=pj, pp=pp, pe=None, full_rows=full_rows,
                   ed_full=ed_full, pending=pending)
    return vis, sed


def compute_ed_matrix_accel(qd: QueryData, rd: RefData, visits: Visits,
                            smat: np.ndarray | None = None,
                            defer: bool = False) -> SparseED:
    """Phase A over candidate pairs only (sparse); full scan for the rest.

    With defer=True the device chunks are only dispatched; call
    .materialize() (or select_pods, which does) to sync -- letting the
    caller overlap host work with the device scan.
    """
    if smat is None:
        smat = score_matrix()
    nj = len(qd.seqs)
    full_rows = np.nonzero(visits.full)[0]
    if len(full_rows):
        sub = _subset_qd(qd, list(full_rows))
        ed_full = compute_ed_matrix(sub, rd, smat)
    else:
        ed_full = np.zeros((0, rd.tot_units), dtype=np.uint8)
    # expand visit clumps into 16-lane unit pairs, all-vectorized
    pj, pp = expand_visit_pairs(qd, rd, visits)
    if len(pj):
        pending = _pairs_min_ed(qd, rd, pj, pp, smat, defer=True)
        sed = SparseED(pj=pj, pp=pp, pe=None, full_rows=full_rows,
                       ed_full=ed_full, pending=pending)
        if not defer:
            sed.materialize()
        return sed
    pe = np.zeros(0, dtype=np.int64)
    return SparseED(pj=pj, pp=pp, pe=pe, full_rows=full_rows,
                    ed_full=ed_full)


def expand_visit_pairs(qd: QueryData, rd: RefData, visits: Visits):
    """Expand visit clump lists into (unibin, unit) pair arrays, with
    the sound lane-level pruning applied (see accel_candidates)."""
    nj = len(qd.seqs)
    from .native import expand_pairs_native
    got = expand_pairs_native(
        visits.offs, visits.flat, nj, rd.tot_units, VECSZ,
        visits.filtered if visits.pass_keys is not None else None,
        visits.bad_clump if visits.pass_keys is not None else None,
        visits.pass_keys)
    if got is not None:
        return got
    nvis = visits.offs[1:] - visits.offs[:-1]
    qrep = np.repeat(np.arange(nj, dtype=np.int64), nvis)
    lane = np.arange(VECSZ, dtype=np.int64)
    ps = (visits.flat[:, None] * VECSZ + lane).ravel()
    pjj = np.repeat(qrep, VECSZ)
    mask = ps < rd.tot_units
    pj, pp = pjj[mask], ps[mask]
    if visits.pass_keys is not None and len(pj):
        # sound lane-level pruning: keep unfiltered unibins, BadList
        # clump units, and pairs passing the per-unit pigeonhole bound
        key = pj * rd.tot_units + pp
        loc = np.searchsorted(visits.pass_keys, key)
        np.minimum(loc, max(len(visits.pass_keys) - 1, 0), out=loc)
        hit = (visits.pass_keys[loc] == key) if len(visits.pass_keys) \
            else np.zeros(len(key), dtype=bool)
        keep = (~visits.filtered[pj]) | visits.bad_clump[pp // VECSZ] | hit
        pj, pp = pj[keep], pp[keep]
    return pj, pp


def densify(sed: SparseED, nj: int, tot_units: int) -> np.ndarray:
    """Dense [nj, tot_units] matrix from SparseED (unevaluated = 255)."""
    ed = np.full((nj, tot_units), 255, dtype=np.uint8)
    if len(sed.full_rows):
        ed[sed.full_rows] = sed.ed_full
    if len(sed.pj):
        ed[sed.pj, sed.pp] = sed.pe.astype(np.uint8)
    return ed


def _subset_qd(qd: QueryData, rows: list[int]) -> QueryData:
    import copy
    sub = copy.copy(qd)
    sub.seqs = [qd.seqs[j] for j in rows]
    sub.six = qd.six[rows]
    sub.rc = qd.rc[rows]
    # the row-indexed caches refer to the PARENT's row numbering; a
    # shallow copy would silently serve the wrong queries' planes.
    # Slice the query matrix; the Peq caches rebuild on demand.
    cached = sub.__dict__.pop("_qmat", None)
    for attr in ("_peqcache", "_peqdev"):
        sub.__dict__.pop(attr, None)
    if cached is not None:
        ra = np.asarray(rows, dtype=np.int64)
        sub._qmat = (cached[0][ra], cached[1][ra], cached[2][ra])
    return sub


def _pairs_min_ed(qd: QueryData, rd: RefData, pj: np.ndarray,
                  pp: np.ndarray, smat: np.ndarray,
                  defer: bool = False):
    """Paired phase A (burst.c accel inner loop): bucketed like rescore.

    All kernel chunks are dispatched asynchronously and converted to
    host arrays only at the end -- per-chunk syncs serialize on the
    device round-trip latency and dominate wall time otherwise.
    """
    n = len(pj)
    out = np.full(n, 255, dtype=np.int64)
    qmat, qlens_all, qw_all = _query_matrix(qd)
    qws = qw_all[pj]
    lbs = _unit_lb(rd)[pp]
    order = np.arange(n)
    pending = []                     # (part, result)
    for W in np.unique(qws):
        for lb in np.unique(lbs[qws == W]):
            sel = order[(qws == W) & (lbs == lb)]
            nbkt = int(np.count_nonzero(_unit_lb(rd) == lb))
            slab = _slab_rows_for(nbkt, int(lb) + 32)
            if slab is not None:
                # bucket exceeds the HBM tile budget: double-buffered
                # slab rotation; results come back pre-resolved
                pending.extend(_pairs_slab_stream(
                    qd, rd, sel, pj, pp, int(W), int(lb), slab, smat))
                continue
            use_dev = devtime.device_ok()
            bpos = np.nonzero(_unit_lb(rd) == lb)[0]
            tiles_h, pos2row = _tile_matrix(rd, int(lb), bpos, 32)
            row2local, peq_h = _peq_cache(qd, int(W), smat)
            if use_dev:
                _, tiles_dev = _tiles_device(rd, int(lb), 32)
                _, peq_dev = _peq_device(qd, int(W), smat)
            trows = pos2row[pp[sel]]
            prows = row2local[pj[sel]]
            pchunk = min(QCHUNK * 4, _pow2_ceil(len(sel)))
            for s0 in range(0, len(sel), pchunk):
                part = sel[s0:s0 + pchunk]
                pidx = np.zeros(pchunk, np.int32)
                tidx = np.zeros(pchunk, np.int32)
                pidx[: len(part)] = prows[s0:s0 + pchunk]
                tidx[: len(part)] = trows[s0:s0 + pchunk]
                if use_dev:
                    pending.append((part, _myers_pairs_dispatch(
                        peq_dev, tiles_dev, pidx, tidx, int(W))))
                else:
                    from .kernels.host import myers_pairs_host
                    pending.append((part, myers_pairs_host(
                        peq_h, tiles_h, pidx, tidx, int(W),
                        n=len(part))))
    if defer:
        return pending
    if pending:
        host = devtime.fetch([res for _, res in pending])
        for (part, _), h in zip(pending, host):
            out[part] = (h[0] if h.ndim == 2 else h)[: len(part)]
    return out


def _winner_tiles_device(rd: RefData, lb: int, pad: int, positions,
                         want_dev: bool = True):
    """Compact tile matrix holding only the given sorted-unit positions
    (rescore against an over-budget bucket: the winner set is tiny next
    to the bucket, so gathering their rows host-side and uploading just
    those bounds HBM at O(winners)). Returns (pos2row, device matrix or
    None, host matrix)."""
    uniq = np.unique(np.asarray(positions, dtype=np.int64))
    mat = np.zeros((max(len(uniq), 1), lb + pad), dtype=np.uint8)
    for i, p in enumerate(uniq):
        s = rd.seqs[rd.ix_srt[p]]
        mat[i, : len(s)] = s
    if mat.shape[0] % 8:
        mat = _pad_rows(mat, -(-mat.shape[0] // 8) * 8)
    pos2row = np.full(rd.tot_units, -1, dtype=np.int64)
    pos2row[uniq] = np.arange(len(uniq))
    if not want_dev:
        return pos2row, None, mat
    import jax.numpy as jnp
    return pos2row, jnp.asarray(mat), mat


def _pairs_slab_stream(qd: QueryData, rd: RefData, sel, pj, pp, W: int,
                       lb: int, slab: int, smat: np.ndarray):
    """Phase-A pairs against a bucket too big for resident HBM tiles:
    pairs are grouped by tile slab; slab i+1 uploads and dispatches
    while slab i's results drain (one slab-deep pipeline bounds device
    memory at two slabs). Returns pre-resolved (part, host result)
    chunks compatible with the deferred-pending protocol."""
    bpos = np.nonzero(_unit_lb(rd) == lb)[0]
    tmat, pos2row = _tile_matrix(rd, lb, bpos, 32)
    row2local, peq_h = _peq_cache(qd, W, smat)
    trows = pos2row[pp[sel]]
    so = np.argsort(trows, kind="stable")
    sel_s, trows_s = sel[so], trows[so]
    sids = trows_s // slab

    def _resolve(chunks, into):
        host = devtime.fetch([d for _, d in chunks])
        for (part, _), h in zip(chunks, host):
            into.append((part, h))

    resolved: list = []
    inflight: list = []
    for sid in np.unique(sids):
        g0, g1 = np.searchsorted(sids, [sid, sid + 1])
        lo = int(sid) * slab
        hs = tmat[lo: lo + slab]
        if hs.shape[0] % 8:
            hs = _pad_rows(hs, -(-hs.shape[0] // 8) * 8)
        use_dev = devtime.device_ok()
        if use_dev:
            import jax.numpy as jnp
            _, peq_dev = _peq_device(qd, W, smat)
            tiles_dev = jnp.asarray(hs)
        part_all = sel_s[g0:g1]
        prows = row2local[pj[part_all]]
        tloc = trows_s[g0:g1] - lo
        chunks = []
        pchunk = min(QCHUNK * 4, _pow2_ceil(g1 - g0))
        for s0 in range(0, g1 - g0, pchunk):
            part = part_all[s0:s0 + pchunk]
            pidx = np.zeros(pchunk, np.int32)
            tidx = np.zeros(pchunk, np.int32)
            pidx[: len(part)] = prows[s0:s0 + pchunk]
            tidx[: len(part)] = tloc[s0:s0 + pchunk]
            if use_dev:
                chunks.append((part, _myers_pairs_dispatch(
                    peq_dev, tiles_dev, pidx, tidx, W)))
            else:
                from .kernels.host import myers_pairs_host
                chunks.append((part, myers_pairs_host(
                    peq_h, hs, pidx, tidx, W, n=len(part))))
        if inflight:
            _resolve(inflight, resolved)
        inflight = chunks
    if inflight:
        _resolve(inflight, resolved)
    return resolved


def accel_pod_order(qd: QueryData, rd: RefData, visits: Visits,
                    juni, refpos, eds):
    """Order winner pods like the reference accel path's linked lists:
    per base query, forward-strand pods then reverse (fold at
    burst.c:4299-4312), each block in reverse insertion order
    (clump visit rank desc, lane desc)."""
    n = len(juni)
    nj = len(visits.full)
    n_clumps = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    # per-unibin visit rank lookup via sorted (unibin, clump) keys
    nvis = visits.offs[1:] - visits.offs[:-1]
    vq = np.repeat(np.arange(nj, dtype=np.int64), nvis)
    vrank = np.arange(len(visits.flat), dtype=np.int64) - visits.offs[vq]
    vkey = vq * n_clumps + visits.flat
    so = np.argsort(vkey)
    vkey_s, vrank_s = vkey[so], vrank[so]
    clump = refpos // VECSZ
    rank = np.empty(n, dtype=np.int64)
    pod_full = visits.full[juni]
    rank[pod_full] = -1 - clump[pod_full]  # full-path: clump desc == rank asc
    acc_ix = np.nonzero(~pod_full)[0]
    if acc_ix.size:
        key = juni[acc_ix] * n_clumps + clump[acc_ix]
        rank[acc_ix] = vrank_s[np.searchsorted(vkey_s, key)]
    lane = refpos % VECSZ
    is_rc = qd.rc[juni].astype(np.int64)
    # full-path pods (rank<0) keep full-path ordering among themselves;
    # they belong to bad-bin queries, disjoint from accel queries.
    full_mask = rank < 0
    keys_full = np.lexsort((-lane[full_mask], -juni[full_mask],
                            rank[full_mask]))
    keys_acc = np.lexsort((-lane[~full_mask], -rank[~full_mask],
                           is_rc[~full_mask], qd.six[juni[~full_mask]]))
    idx_full = np.nonzero(full_mask)[0][keys_full]
    idx_acc = np.nonzero(~full_mask)[0][keys_acc]
    return np.concatenate([idx_acc, idx_full])
