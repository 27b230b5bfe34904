"""Multi-chip distribution: database-sharded alignment over a device mesh.

The reference is single-node OpenMP; its cross-thread merge points
(per-thread pod consolidation burst.c:4490-4519, global budget
tightening :4433) become mesh collectives here:

  * reference tiles are sharded across the 'db' mesh axis (each device
    owns a contiguous slab of the sorted tile array);
  * query blocks are replicated (or sharded along a 'q' data axis for
    throughput runs);
  * each device scans its slab with the Myers kernel; per-query minima
    merge via jax.lax.pmin-equivalent psum-min inside shard_map;
  * winner identification happens on the host from the gathered
    [Q, T_total] matrix (identical to single-device results).

Because the merged ED matrix is exactly the single-device matrix, all
downstream mode logic (ties, CAPITALIST set cover, reporting) is
unchanged and the sharded path stays bit-identical.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels import myers


def make_mesh(n_devices: int | None = None, axis: str = "db") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh2(n_shards: int, q_shards: int = 1) -> Mesh:
    """2D (q x db) mesh: query blocks data-parallel along 'q', the
    reference database model-parallel along 'db' (SURVEY.md section
    2.3's two decompositions composed). q_shards=1 degenerates to the
    db-only layout."""
    devs = jax.devices()[: n_shards * q_shards]
    return Mesh(np.array(devs).reshape(q_shards, n_shards),
                ("q", "db"))


@functools.partial(jax.jit, static_argnames=("W", "mesh"))
def _sharded_scan(peq, tiles, W: int, mesh: Mesh):
    """Scan q-sharded [Q] queries against db-sharded [T, Lp] tiles ->
    [Q, T] ED (Q must divide by the q axis, T by the db axis)."""
    def per_shard(peq_l, tiles_l):
        return myers.myers_min_ed_cross(peq_l, tiles_l, W)

    fn = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("q", None, None), P("db", None)),
        out_specs=P("q", "db"),
        check_vma=False)  # scan carry is constant-initialized per shard
    return fn(peq, tiles)


def _sharded_tiles(rd, n_shards: int, pad: int, weights=None,
                   q_shards: int = 1):
    """Tile rows in sorted-unit order, partitioned into n_shards
    CONTIGUOUS slabs balanced by `weights` (candidate mass per sorted
    unit; None = equal unit counts), each slab padded to the tallest.
    Shard s owns sorted positions [starts[s], starts[s+1]) at local
    rows 0..; returns (tiles_dev [S*rows_max, Lmax+pad], starts [S+1],
    rows_max, Lmax+pad), tiles_dev placed slab s on the 'db' index s
    of the (q x db) mesh. Cached per (S, pad, q): the first batch's
    weights fix the partition, later batches reuse the resident tiles.

    The reference's analog is OpenMP *dynamic* scheduling over clumps
    (burst.c:4343-4344), which self-balances; across chips there is no
    cheap work stealing, so static mass-balanced ownership plays that
    role -- equal-count slabs measured load_balance 0.82 on clustered
    DBs (SCALING.md), bounding eff(8) below the 80% target."""
    from .. import engine as _eng

    cache = getattr(rd, "_shardtiles", None)
    if cache is None:
        cache = rd._shardtiles = {}
    got = cache.get((n_shards, pad, q_shards))
    if got is None:
        tot = rd.tot_units
        lmax = int(max((len(rd.seqs[rd.ix_srt[p]])
                        for p in range(tot)), default=1))
        if weights is not None and n_shards > 1 and tot:
            # equal-mass prefix split of the cumulative weight curve
            # (+epsilon keeps zero-mass runs spread across shards)
            w = np.asarray(weights, np.float64)[:tot] + 1e-3
            cw = np.cumsum(w)
            cuts = np.searchsorted(
                cw, cw[-1] * np.arange(1, n_shards) / n_shards)
            starts = np.concatenate(
                ([0], cuts, [tot])).astype(np.int64)
            np.maximum.accumulate(starts, out=starts)
        else:
            slab = -(-tot // n_shards) if tot else 1
            starts = np.minimum(
                np.arange(n_shards + 1, dtype=np.int64) * slab, tot)
        rows_max = int(max((starts[1:] - starts[:-1]).max(), 1))
        mat = np.zeros((rows_max * n_shards, lmax + pad),
                       dtype=np.uint8)
        for s in range(n_shards):
            pos = np.arange(starts[s], starts[s + 1], dtype=np.int64)
            _eng._fill_rows(mat[s * rows_max: s * rows_max + len(pos)],
                            rd, pos)
        tiles_dev = jax.device_put(mat, NamedSharding(
            make_mesh2(n_shards, q_shards), P("db", None)))
        got = cache[(n_shards, pad, q_shards)] = (tiles_dev, starts,
                                                  rows_max, lmax + pad)
    return got


def _pad_peq_interleave_q(peq, q_shards: int):
    """Pad Peq rows to a q_shards multiple and permute them so shard s
    owns original rows s, s+Q, s+2Q, ... (round-robin). Lexicographic
    neighbors (similar queries, hence similar candidate-DB regions) so
    spread across q-shards, which decorrelates the q x db load grid:
    each q-shard's db-mass distribution approximates the global one
    and the db equal-mass cuts balance every row of the grid.
    Returns (peq_perm, rq); original row r lives on shard r % Q at
    local row r // Q."""
    R = peq.shape[0]
    rq = -(-R // q_shards)
    if rq * q_shards != R:
        pad = np.zeros((rq * q_shards - R,) + peq.shape[1:], peq.dtype)
        peq = np.concatenate([peq, pad], axis=0)
    if q_shards > 1:
        perm = np.arange(rq * q_shards).reshape(rq, q_shards).T.ravel()
        peq = peq[perm]
    return peq, rq


def _pad_peq_q(peq, q_shards: int):
    """Pad Peq rows to a q_shards multiple; returns (peq_pad, rq)."""
    R = peq.shape[0]
    rq = -(-R // q_shards)
    if rq * q_shards != R:
        pad = np.zeros((rq * q_shards - R,) + peq.shape[1:], peq.dtype)
        peq = np.concatenate([np.asarray(peq), pad])
    return peq, rq


def _pow2(n: int, lo: int = 16) -> int:
    """Next size in {2^k, 3*2^(k-1)} >= n (>= lo): buckets the
    per-batch routing shapes so the jitted shard_map functions below
    hit their compile cache across batches instead of retracing on
    every distinct pair count; the 3*2^(k-1) midpoints cap the padding
    waste at 33% (plain pow2 wastes up to 2x, which showed up directly
    in the shards=1 rescore wall time)."""
    p = lo
    while p < n:
        if p + (p >> 1) >= n:
            return p + (p >> 1)
        p <<= 1
    return p


@functools.partial(jax.jit, static_argnames=("W", "mesh"))
def _pairs_scan_sharded(peq, tiles, pidx_m, tloc_m, W: int, mesh: Mesh):
    """Routed phase-A pair scan on the (q x db) mesh. Module-level and
    jitted with (W, mesh) static: one compile per (mesh, W, shape
    bucket) for the process lifetime -- NOT per call (the round-4
    version rebuilt jit(shard_map) inside the per-W loop, paying a
    retrace + dispatch rebuild every batch; SCALING_SHARDS1_r04's 29x
    overhead was mostly that)."""
    def per_shard(peq_l, tiles_l, pidx_l, tloc_l):
        return myers.myers_min_ed_gather_pos(
            peq_l, tiles_l, pidx_l[0, 0], tloc_l[0, 0], W)[None, None]

    return jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("q", None, None), P("db", None),
                  P("q", "db", None), P("q", "db", None)),
        out_specs=P("q", "db", None, None),
        check_vma=False)(peq, tiles, pidx_m, tloc_m)


@functools.lru_cache(maxsize=None)
def _rescore_sharded_fn(mesh: Mesh, W: int, smat_key: bytes,
                        smat_shape: tuple, levels: int | None = None,
                        rows: int | None = None):
    """Compiled routed phase-B rescore for (mesh, W, score-matrix);
    cached for the process lifetime (same rationale as
    _pairs_scan_sharded). `levels`/`rows` narrow the chain look-back
    and the row count exactly as the plain path does."""
    from ..kernels.rescore import make_rescore

    smat = np.frombuffer(smat_key, dtype=np.uint8).reshape(smat_shape)
    core = make_rescore(smat)

    def per_shard(peq_l, tiles_l, pidx_l, tloc_l, qlen_l, bnd_l):
        pq = jnp.take(peq_l, pidx_l[0, 0], axis=0)
        tl = jnp.take(tiles_l, tloc_l[0, 0], axis=0)
        return jnp.stack(core(pq, qlen_l[0, 0], tl, bnd_l[0, 0],
                              W, levels, rows))[None, None]

    return jax.jit(jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("q", None, None), P("db", None),
                  P("q", "db", None), P("q", "db", None),
                  P("q", "db", None), P("q", "db", None)),
        out_specs=P("q", "db", None, None),
        check_vma=False))


@functools.lru_cache(maxsize=None)
def _rescore_sharded_win_fn(mesh: Mesh, W: int, Lw: int,
                            smat_key: bytes, smat_shape: tuple,
                            levels: int | None = None,
                            rows: int | None = None):
    """Windowed variant of _rescore_sharded_fn: each pair's DP runs on
    its [Lw-1]-column window starting at the routed x0 (same soundness
    as engine.rescore_winners' windowed subset: the window covers every
    optimal path implied by the phase-A first/last best columns plus
    the error-budget margin). Cuts the per-pair DP from the full slab
    width (~lmax+pad columns) to ~rows+budget columns -- the full-width
    form made the sharded rescore 30x the plain path's cost."""
    from ..kernels.rescore import _window_tiles, make_rescore

    smat = np.frombuffer(smat_key, dtype=np.uint8).reshape(smat_shape)
    core = make_rescore(smat)

    def per_shard(peq_l, tiles_l, pidx_l, tloc_l, qlen_l, bnd_l, x0_l):
        pq = jnp.take(peq_l, pidx_l[0, 0], axis=0)
        tl = jnp.take(tiles_l, tloc_l[0, 0], axis=0)
        win = _window_tiles(tl, x0_l[0, 0], Lw)
        return jnp.stack(core(pq, qlen_l[0, 0], win, bnd_l[0, 0],
                              W, levels, rows))[None, None]

    return jax.jit(jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("q", None, None), P("db", None),
                  P("q", "db", None), P("q", "db", None),
                  P("q", "db", None), P("q", "db", None),
                  P("q", "db", None)),
        out_specs=P("q", "db", None, None),
        check_vma=False))


def _stat_add(stats, key, val):
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + val


def _stat_pairs(stats, shard, nsh):
    if stats is not None:
        c = np.bincount(shard, minlength=nsh).astype(np.int64)
        prev = stats.get("pairs_per_shard")
        stats["pairs_per_shard"] = c if prev is None else prev + c


def compute_ed_matrix_accel_sharded(qd, rd, visits, smat,
                                    n_shards: int, q_shards: int = 1,
                                    stats: dict | None = None):
    """Phase A over accelerator candidate pairs on a (q x db) mesh
    (the production multi-chip layout, SURVEY.md section 2.3): each
    db-shard owns a contiguous slab of the sorted unit array, each
    q-shard a block of the query Peq rows; candidate pairs route to
    the (q, db) device owning their (query, unit). Per-shard packed
    (ed, first, last) results merge on the host, which reproduces the
    reference's cross-thread pod consolidation (burst.c:4490-4519) --
    the resulting SparseED is identical to the single-device one, so
    every downstream mode stays bit-identical.

    `stats` (optional dict) accumulates scaling diagnostics: route_s
    (host-side pair->shard routing), scan_s (blocked on the sharded
    device scan), merge_s (host-side result merge), pairs_per_shard
    (load balance across the flat q*db shard grid) -- the inputs to a
    scaling-efficiency report.
    """
    import time as _time

    from .. import engine

    mesh = make_mesh2(n_shards, q_shards)
    full_rows = np.nonzero(visits.full)[0]
    if len(full_rows):
        sub = engine._subset_qd(qd, list(full_rows))
        ed_full = compute_ed_matrix_sharded(sub, rd, smat, n_shards,
                                            q_shards=q_shards)
    else:
        ed_full = np.zeros((0, rd.tot_units), dtype=np.uint8)
    pj, pp = engine.expand_visit_pairs(qd, rd, visits)
    n = len(pj)
    sed = engine.SparseED(
        pj=pj, pp=pp, pe=np.full(n, 255, np.int64), full_rows=full_rows,
        ed_full=ed_full, plast=np.full(n, -1, np.int64),
        pfirst=np.full(n, -1, np.int64))
    if not n:
        return sed
    qmat, qlens_all, qw_all = engine._query_matrix(qd)
    qws = qw_all[pj]
    order = np.arange(n)
    for W in np.unique(qws):
        t0 = _time.perf_counter()
        sel = order[qws == W]
        row2local, peq = engine._peq_cache(qd, int(W), smat)
        # bucket the query-row count too (same compile-cache argument)
        Rp = _pow2(peq.shape[0])
        if Rp != peq.shape[0]:
            peq = np.concatenate([np.asarray(peq), np.zeros(
                (Rp - peq.shape[0],) + peq.shape[1:], peq.dtype)])
        peq, rq = _pad_peq_interleave_q(peq, q_shards)
        tiles_dev, starts, _, lp = _sharded_tiles(
            rd, n_shards, 32,
            weights=np.bincount(pp, minlength=rd.tot_units),
            q_shards=q_shards)
        qrow = row2local[pj[sel]]
        qs = qrow % q_shards
        ds = np.searchsorted(starts, pp[sel], side="right") - 1
        shard = qs * n_shards + ds            # flat (q, db) shard id
        tloc = pp[sel] - starts[ds]
        nsh = q_shards * n_shards
        counts = np.bincount(shard, minlength=nsh)
        pmax = _pow2(max(int(counts.max()), 1))
        pidx_m = np.zeros((q_shards, n_shards, pmax), np.int32)
        tloc_m = np.zeros((q_shards, n_shards, pmax), np.int32)
        so = np.argsort(shard, kind="stable")
        pos_in_shard = np.empty(len(sel), np.int64)
        off = np.concatenate(([0], np.cumsum(counts)[:-1]))
        pos_in_shard[so] = np.arange(len(sel)) - off[shard[so]]
        pidx_m[qs, ds, pos_in_shard] = (qrow // q_shards).astype(np.int32)
        tloc_m[qs, ds, pos_in_shard] = tloc.astype(np.int32)
        _stat_pairs(stats, shard, nsh)
        t1 = _time.perf_counter()
        _stat_add(stats, "route_s", t1 - t0)
        out = np.asarray(_pairs_scan_sharded(
            jnp.asarray(peq), tiles_dev, jnp.asarray(pidx_m),
            jnp.asarray(tloc_m), int(W), mesh))
        t2 = _time.perf_counter()
        _stat_add(stats, "scan_s", t2 - t1)
        sed.pe[sel] = np.minimum(out[qs, ds, 0, pos_in_shard], 255)
        sed.pfirst[sel] = out[qs, ds, 1, pos_in_shard]
        sed.plast[sel] = out[qs, ds, 2, pos_in_shard]
        _stat_add(stats, "merge_s", _time.perf_counter() - t2)
    return sed


def rescore_winners_sharded(qd, rd, juni, refpos, eds, mode, smat,
                            n_shards: int, pod_order=None,
                            q_shards: int = 1,
                            stats: dict | None = None,
                            win_cols=None):
    """Phase B with winners routed to the (q, db) shard owning their
    (query block, unit slab).

    Per-shard tie-aware rescore (kernels/rescore core) over the same
    sharded tile slabs; merged host-side into Pods identical to
    engine.rescore_winners. With `win_cols` (the phase-A first/last
    best columns, SparseED.lookup_cols) each pair that fits runs on its
    [Lw-1]-column window exactly like the plain path -- without it the
    full-slab-width DP costs many times more. `stats` accumulates
    route_s/scan_s/merge_s/pairs_per_shard as in
    compute_ed_matrix_accel_sharded.
    """
    import time as _time

    from .. import engine
    from ..kernels.rescore import _levels_for, rescore_finalize_host

    mesh = make_mesh2(n_shards, q_shards)
    n = len(juni)
    gap_q = np.zeros(n, np.int64)
    gap_r = np.zeros(n, np.int64)
    fpos = np.zeros(n, np.int64)
    score = np.zeros(n, np.float32)
    out_ed = np.array(eds, dtype=np.int64)
    budgets = qd.ed
    if mode in ("FORAGE", "ANY"):
        bound = budgets[qd.six[juni]]
    else:
        bound = out_ed
    qmat, qlens_all, qw_all = engine._query_matrix(qd)
    qws = qw_all[juni] if n else np.zeros(0, np.int64)
    order = np.arange(n)
    # per-pair window offsets + the exact-match shortcut, both
    # engine.rescore_winners' formulas (ED==0 winners skip the DP:
    # score 1.0, final position from the phase-A last best column)
    todo = np.ones(n, dtype=bool)
    x0_all = np.full(n, -1, dtype=np.int64)
    span_all = np.zeros(n, dtype=np.int64)
    if win_cols is not None and n:
        first_m = np.asarray(win_cols[0], dtype=np.int64)
        last_m = np.asarray(win_cols[1], dtype=np.int64)
        skip = (out_ed == 0) & (last_m > 0)
        if skip.any():
            score[skip] = np.float32(1.0)
            fpos[skip] = last_m[skip] - \
                (qws[skip] * 32 - qlens_all[juni[skip]])
            todo &= ~skip
        known = (first_m > 0) & (last_m > 0)
        x0c = np.maximum(first_m - qws * 32 - bound - 1, 0)
        x0_all[known] = x0c[known]
        span_all[known] = (last_m - first_m)[known]
    for W in (np.unique(qws[todo]) if n else ()):
        t0 = _time.perf_counter()
        wsel = order[todo & (qws == W)]
        row2local, peq = engine._peq_cache(qd, int(W), smat)
        # bucket the query-row count too (same compile-cache argument)
        Rp = _pow2(peq.shape[0])
        if Rp != peq.shape[0]:
            peq = np.concatenate([np.asarray(peq), np.zeros(
                (Rp - peq.shape[0],) + peq.shape[1:], peq.dtype)])
        peq, rq = _pad_peq_interleave_q(peq, q_shards)
        m_pad = int(W) * 32
        tiles_dev, starts, _, lp = _sharded_tiles(
            rd, n_shards, m_pad,
            weights=np.bincount(refpos, minlength=rd.tot_units),
            q_shards=q_shards)
        peq_d = jnp.asarray(peq)
        bmax = int(bound[wsel].max()) if len(wsel) else 0
        qmax = int(qlens_all[juni[wsel]].max()) if len(wsel) else 2
        rows_g = min(m_pad, -(-qmax // 8) * 8)
        levels = _levels_for(bound[wsel])
        Lw = -(-(rows_g + bmax + 2) // 128) * 128
        L1_full = -(-(lp + 1) // 128) * 128
        fits = (x0_all[wsel] >= 0) & \
            (span_all[wsel] <= Lw - 1 - rows_g - bound[wsel] - 1)
        if Lw >= L1_full:
            fits &= False
        t1 = _time.perf_counter()
        _stat_add(stats, "route_s", t1 - t0)
        for sel, windowed in ((wsel[fits], True),
                              (wsel[~fits], False)):
            if not len(sel):
                continue
            _stat_add(stats, "win_pairs" if windowed else "full_pairs",
                      float(len(sel)))
            t0 = _time.perf_counter()
            qrow = row2local[juni[sel]]
            qs = qrow % q_shards
            ds = np.searchsorted(starts, refpos[sel], side="right") - 1
            shard = qs * n_shards + ds
            tloc = refpos[sel] - starts[ds]
            counts = np.bincount(shard, minlength=q_shards * n_shards)
            pmax = _pow2(max(int(counts.max()), 1))
            pidx_m = np.zeros((q_shards, n_shards, pmax), np.int32)
            tloc_m = np.zeros((q_shards, n_shards, pmax), np.int32)
            qlen_m = np.full((q_shards, n_shards, pmax), 2, np.int32)
            bnd_m = np.zeros((q_shards, n_shards, pmax), np.int32)
            x0_m = np.zeros((q_shards, n_shards, pmax), np.int32)
            so = np.argsort(shard, kind="stable")
            off = np.concatenate(([0], np.cumsum(counts)[:-1]))
            pos_in_shard = np.empty(len(sel), np.int64)
            pos_in_shard[so] = np.arange(len(sel)) - off[shard[so]]
            pidx_m[qs, ds, pos_in_shard] = \
                (qrow // q_shards).astype(np.int32)
            tloc_m[qs, ds, pos_in_shard] = tloc.astype(np.int32)
            qlen_m[qs, ds, pos_in_shard] = \
                qlens_all[juni[sel]].astype(np.int32)
            bnd_m[qs, ds, pos_in_shard] = bound[sel].astype(np.int32)
            if windowed:
                x0_m[qs, ds, pos_in_shard] = x0_all[sel].astype(np.int32)
            _stat_pairs(stats, shard, q_shards * n_shards)
            t1 = _time.perf_counter()
            _stat_add(stats, "route_s", t1 - t0)
            if windowed:
                fn = _rescore_sharded_win_fn(
                    mesh, int(W), int(Lw), smat.tobytes(), smat.shape,
                    levels, rows_g)
                out = np.asarray(fn(
                    peq_d, tiles_dev, jnp.asarray(pidx_m),
                    jnp.asarray(tloc_m), jnp.asarray(qlen_m),
                    jnp.asarray(bnd_m), jnp.asarray(x0_m)))
            else:
                fn = _rescore_sharded_fn(mesh, int(W), smat.tobytes(),
                                         smat.shape, None, rows_g)
                out = np.asarray(fn(
                    peq_d, tiles_dev, jnp.asarray(pidx_m),
                    jnp.asarray(tloc_m), jnp.asarray(qlen_m),
                    jnp.asarray(bnd_m)))
            t2 = _time.perf_counter()
            _stat_add(stats, "scan_s", t2 - t1)
            e, gq, gr, fp, sc = rescore_finalize_host(
                out[qs, ds, 0, pos_in_shard],
                out[qs, ds, 1, pos_in_shard],
                out[qs, ds, 2, pos_in_shard],
                out[qs, ds, 3, pos_in_shard],
                qlens_all[juni[sel]])
            out_ed[sel] = e
            gap_q[sel] = gq
            gap_r[sel] = gr
            fpos[sel] = fp + (x0_all[sel] if windowed else 0)
            score[sel] = sc
            _stat_add(stats, "merge_s", _time.perf_counter() - t2)
    # pod ordering identical to engine.rescore_winners
    if pod_order is not None:
        srt = pod_order
    else:
        clump = refpos // engine.VECSZ
        lane = refpos % engine.VECSZ
        srt = np.lexsort((-lane, -juni, -clump))
    return engine.Pods(
        six=qd.six[juni][srt], juni=juni[srt], refpos=refpos[srt],
        ed=out_ed[srt], rc=qd.rc[juni][srt], gap_q=gap_q[srt],
        gap_r=gap_r[srt], final_pos=fpos[srt], score=score[srt])


def compute_ed_matrix_sharded(qd, rd, smat, n_shards: int,
                              tile_gran: int = 64,
                              q_shards: int = 1) -> np.ndarray:
    """Sharded phase A producing the same [numUnibins, tot_units] matrix."""
    mesh = make_mesh2(n_shards, q_shards)
    nj = len(qd.seqs)
    ed = np.full((nj, rd.tot_units), 255, dtype=np.uint8)

    qbuckets: dict[int, list[int]] = {}
    for j, s in enumerate(qd.seqs):
        qbuckets.setdefault(myers.words_for(len(s)), []).append(j)
    ubuckets: dict[int, list[int]] = {}
    for p in range(rd.tot_units):
        ln = int(rd.lens[rd.ix_srt[p]])
        lb = -(-max(ln, 1) // tile_gran) * tile_gran
        ubuckets.setdefault(lb, []).append(p)

    for W, rows in sorted(qbuckets.items()):
        m_pad = W * 32
        qarr = np.zeros((len(rows), m_pad), dtype=np.uint8)
        qlens = np.zeros(len(rows), dtype=np.int64)
        for i, j in enumerate(rows):
            s = qd.seqs[j]
            qarr[i, : len(s)] = s
            qlens[i] = len(s)
        peq, _rq = _pad_peq_q(myers.build_peq(qarr, qlens, W, smat),
                              q_shards)
        for lb, poss in sorted(ubuckets.items()):
            lp = lb + 32
            # pad tile count to a multiple of the shard count
            tpad = -(-len(poss) // n_shards) * n_shards
            tiles = np.zeros((tpad, lp), dtype=np.uint8)
            for i, p in enumerate(poss):
                s = rd.seqs[rd.ix_srt[p]]
                tiles[i, : len(s)] = s
            block = np.asarray(_sharded_scan(
                jnp.asarray(peq), jnp.asarray(tiles), W, mesh))
            block = np.minimum(block[: len(rows), : len(poss)],
                               255).astype(np.uint8)
            ed[np.ix_(rows, poss)] = block
    return ed
