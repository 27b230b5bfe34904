"""Multi-HOST (multi-process) distribution: DB shards over DCN.

The reference is single-node OpenMP; its cross-thread merge points
become cross-process collectives here, one per merge point in
/root/reference/burst.c:

  * per-thread pod consolidation (burst.c:4490-4519)  -> winner-stat
    gather to host 0 before reporting;
  * global best-ED tightening (burst.c:4433)          -> elementwise
    min-reduce of per-pair phase-A EDs across hosts;
  * the scour candidate lists (burst.c:4096-4130)     -> allgather of
    per-host raw candidates, reassembled identically everywhere.

Layout: each process owns a contiguous CLUMP range of the sorted unit
array -- its slice of the .edx tile data (db/edx.read_edx clump_range)
and the .acx postings filtered to those clumps (accel.read_acx
clump_range). Queries are replicated: query processing is deterministic,
so every host derives identical unibins, budgets, and bins. Because
candidate tuples, pair EDs, and the visit assembly are merged to the
same values the single process computes, every downstream stage
(select_pods, rescore, pod ordering, reporters) is reused unchanged and
the b6 output is byte-identical to a single-process run.

Launch recipe (N processes, one per host; process 0 writes the b6):

    BURST_TPU_MULTIHOST="<pid>/<nprocs>@<coordinator_host:port>" \
        python -m burst_tpu.cli -q q.fa -r db.edx -a db.acx -o out.b6 ...

On a GPU cluster each process also owns its local cards
(jax.distributed wires the collectives); for CPU validation set
JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=<n>. See
tools/launch_multihost.py for a single-machine spawner.
"""
from __future__ import annotations

import os

import numpy as np

VECSZ = 16


def parse_spec(spec: str):
    """"<pid>/<nprocs>@<host:port>" -> (pid, nprocs, coordinator)."""
    head, _, coord = spec.partition("@")
    pid_s, _, np_s = head.partition("/")
    pid, nprocs = int(pid_s), int(np_s)
    if not coord or not (0 <= pid < nprocs):
        raise ValueError(f"bad BURST_TPU_MULTIHOST spec: {spec!r}")
    return pid, nprocs, coord


def clump_bounds(n_clumps: int, nprocs: int, pid: int):
    """Contiguous clump slabs (host h owns [h*slab, (h+1)*slab))."""
    slab = -(-n_clumps // nprocs)
    return min(pid * slab, n_clumps), min((pid + 1) * slab, n_clumps)


def _gather_min(arr: np.ndarray) -> np.ndarray:
    """Elementwise min across processes (same shape everywhere).

    Local entries hold real values, non-local the 255/max sentinel, so
    the min IS the merge (burst.c:4433's budget-tightening analog)."""
    from jax.experimental import multihost_utils as mhu
    g = np.asarray(mhu.process_allgather(arr))
    return g.min(axis=0)


def _gather_concat(arrs: list[np.ndarray]):
    """Allgather variable-length per-host arrays; returns the list of
    per-host parts in process order (identical on every host)."""
    from jax.experimental import multihost_utils as mhu
    cols = len(arrs)
    lens = np.array([len(a) for a in arrs], dtype=np.int64)
    glens = np.asarray(mhu.process_allgather(lens))      # [nproc, cols]
    m = int(glens.max()) if glens.size else 0
    out = []
    for c in range(cols):
        a = arrs[c]
        pad = np.zeros(m, dtype=a.dtype)
        pad[: len(a)] = a
        g = np.asarray(mhu.process_allgather(pad))       # [nproc, m]
        out.append([g[h, : glens[h, c]] for h in range(g.shape[0])])
    return out


def align_multihost(a) -> int:
    """The cli.run align branch, DB-sharded across processes."""
    pid, nprocs, coord = parse_spec(os.environ["BURST_TPU_MULTIHOST"])
    import jax
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nprocs, process_id=pid)

    from .. import engine, modes
    from ..alphabet import score_matrix
    from ..db import edx
    from ..io.fasta import parse_fasta, parse_fasta_fast
    from ..io.taxonomy import Taxonomy
    from ..process import (bin_queries_for_accel, process_queries,
                           process_references)

    smat = score_matrix(a["z"])
    qh, qs = parse_fasta_fast(a["query"])
    qd = process_queries(qh, qs, a["thres"],
                         a["rc"] and not a["prepass"],
                         incl_whitespace=a["whitespace"],
                         xalpha=a["xalpha"])
    if edx.is_edx(a["ref"]):
        n_clumps, tot_units = edx.edx_dims(a["ref"])
        c_lo, c_hi = clump_bounds(n_clumps, nprocs, pid)
        u_lo, u_hi = c_lo * VECSZ, min(c_hi * VECSZ, tot_units)
        rd, dshear = edx.read_edx(a["ref"], xalpha=a["xalpha"],
                                  clump_range=(c_lo, c_hi))
        if dshear and int(np.float32(qd.max_len) / np.float32(a["thres"])
                          ) > dshear:
            print("ERROR: DB incompatible with selected "
                  "queries/identity.")
            if not a["heur"] and not a["prepass"]:
                return 1
    else:
        # raw FASTA: shearing is deterministic, so every host builds
        # the same RefData in-process (mirrors cli.run) and restricts
        # its own work to a clump slab via the u_lo/u_hi pair filters;
        # non-local tiles are never uploaded (burst.c:5139-5141 treats
        # raw FASTA and .edx uniformly)
        rh, rs = parse_fasta(a["ref"])
        rd = process_references(
            rh, rs, max_len_q=qd.max_len, thres=a["thres"],
            rebase=a["rebase"], rebase_amt=a["rebase_amt"],
            curate=1 if a["dedupe"] else 0, xalpha=a["xalpha"],
            do_fp=a["fp"], z=a["z"], latency=a["latency"],
            clustradius=a.get("clustradius", 0))
        tot_units = rd.tot_units
        n_clumps = tot_units // VECSZ + (1 if tot_units % VECSZ else 0)
        c_lo, c_hi = clump_bounds(n_clumps, nprocs, pid)
        u_lo, u_hi = c_lo * VECSZ, min(c_hi * VECSZ, tot_units)
        # engine kernels restrict tile passes to the local slab
        rd.unit_range = (u_lo, u_hi)
    taxonomy = Taxonomy.parse(a["tax"], ncbi=a["taxa_ncbi"]) \
        if a["tax"] else None

    if a["prepass"]:
        return _prepass_multihost(qd, rd, a, taxonomy, smat, pid,
                                  nprocs, u_lo, u_hi, n_clumps, c_lo,
                                  c_hi)

    visits = None
    if a["accel"]:
        from ..accel import read_acx
        acc = read_acx(a["accel"], z_required=a["z"],
                       clump_range=(c_lo, c_hi))
        qbins = bin_queries_for_accel(qd, acc.k, a["z"], a["heur"])
        visits = _visits_multihost(qd, acc, qbins, n_clumps,
                                   a["heur"], a["skipambig"],
                                   a["threads"])
        sed = _phase_a_multihost(qd, rd, visits, smat, u_lo, u_hi)
        ed = sed
    else:
        ed_loc = engine.compute_ed_matrix(qd, rd, smat)
        ed = _gather_min(ed_loc)

    if a["mode"] == "ANY":
        # the hit choice derives from the merged (globally identical)
        # phase-A results, so every host computes it; the rescore is a
        # collective (owner-stitched gather), so every host runs the
        # reporter -- non-zero ranks write to devnull
        rescore_fn = _mh_rescore_fn(u_lo, u_hi, nprocs)
        out_path = a["out"] if pid == 0 else os.devnull
        with open(out_path, "w") as fh:
            writer = modes.B6Writer(fh)
            if isinstance(ed, engine.SparseED):
                n = len(qd.seqs)
                qb = max(1, min(16, n // (max(1, a["threads"]) * 128)))
                modes.report_any_accel(ed, visits, qd, rd, writer,
                                       smat, qbunch=qb,
                                       rescore_fn=rescore_fn)
            else:
                modes.report_any(ed, qd, rd, writer, smat,
                                 rescore_fn=rescore_fn)
        return 0

    juni, refpos, eds = engine.select_pods(qd, rd, ed, a["mode"])
    pod_order = None
    if visits is not None:
        pod_order = engine.accel_pod_order(qd, rd, visits, juni,
                                           refpos, eds)
    pods = _rescore_multihost(qd, rd, juni, refpos, eds, a["mode"],
                              smat, pod_order, u_lo, u_hi, nprocs)

    if pid != 0:
        return 0
    with open(a["out"], "w") as fh:
        writer = modes.B6Writer(fh)
        if a["mode"] in ("ALLPATHS", "FORAGE"):
            modes.report_allpaths_or_forage(
                pods, qd, rd, writer, taxonomy,
                forage=(a["mode"] == "FORAGE"))
        elif a["mode"] == "BEST":
            modes.report_best(pods, qd, rd, writer, taxonomy,
                              a["taxasuppress"], a["strict"])
        elif a["mode"] == "CAPITALIST":
            modes.report_capitalist(pods, qd, rd, writer, taxonomy,
                                    a["taxacut"], a["taxasuppress"],
                                    a["strict"])
    return 0


def _visits_multihost(qd, acc, qbins, n_clumps: int, do_heur: bool,
                      skip_ambig: bool, threads: int):
    """Local scour over the host's posting shard, candidate allgather,
    identical global Visits assembly on every host."""
    from .. import engine

    n = len(qd.seqs)
    b0, b1 = int(qbins[0]), int(qbins[1])
    bad_arr = np.asarray(acc.bad, dtype=np.int64)
    full = np.ones(n, dtype=bool)
    full[:b1] = False
    if skip_ambig:
        bad_arr = bad_arr[:0]
        full[:] = False
    qbunch = engine.default_qbunch(n, threads)
    mm_bunch, mm_inner, n_bunches = engine.bunch_thresholds(
        qd, b1, acc.k, qbunch, do_heur)

    pb = pc = hits = fw = np.zeros(0, np.int64)
    bw = engine.bunch_word_multiset(qd, acc, b0, b1, qbunch, acc.k)
    if bw is not None:
        raw = engine.scour_raw(acc, bw[0], bw[1], bw[2], n_clumps)
        if raw is not None:
            pb, pc, hits, fw = raw
    parts = _gather_concat([pb, pc, hits, fw])
    pb, pc, hits, fw = (np.concatenate(p) for p in parts)
    return engine.assemble_accel_visits(
        n, b0, b1, qbunch, n_bunches, bad_arr, full, pb, pc, hits, fw,
        mm_bunch, mm_inner)


def _phase_a_multihost(qd, rd, visits, smat, u_lo: int, u_hi: int):
    """Phase A on local pairs + local slice of full-scan rows, merged
    into the global SparseED by elementwise min."""
    from .. import engine

    pj, pp = engine.expand_visit_pairs(qd, rd, visits)
    local = (pp >= u_lo) & (pp < u_hi)
    pe = np.full(len(pj), 255, dtype=np.int64)
    if local.any():
        pe[local] = engine._pairs_min_ed(qd, rd, pj[local], pp[local],
                                         smat)
    pe = _gather_min(pe)

    full_rows = np.nonzero(visits.full)[0]
    if len(full_rows):
        sub = engine._subset_qd(qd, list(full_rows))
        ed_full = _gather_min(engine.compute_ed_matrix(sub, rd, smat))
    else:
        ed_full = np.zeros((0, rd.tot_units), dtype=np.uint8)
    return engine.SparseED(pj=pj, pp=pp, pe=pe, full_rows=full_rows,
                           ed_full=ed_full)


def _rescore_multihost(qd, rd, juni, refpos, eds, mode, smat,
                       pod_order, u_lo: int, u_hi: int, nprocs: int):
    """Phase B on locally-owned winners; stats gathered and stitched by
    owner rank (the pod consolidation of burst.c:4490-4519)."""
    from jax.experimental import multihost_utils as mhu

    from .. import engine

    nw = len(juni)
    local = np.nonzero((refpos >= u_lo) & (refpos < u_hi))[0]
    ed_l = np.zeros(nw, np.int64)
    gq_l = np.zeros(nw, np.int64)
    gr_l = np.zeros(nw, np.int64)
    fp_l = np.zeros(nw, np.int64)
    sc_l = np.zeros(nw, np.float32)
    if len(local):
        sub = engine.rescore_winners(
            qd, rd, juni[local], refpos[local], eds[local], mode, smat,
            pod_order=np.arange(len(local)))
        ed_l[local] = sub.ed
        gq_l[local] = sub.gap_q
        gr_l[local] = sub.gap_r
        fp_l[local] = sub.final_pos
        sc_l[local] = sub.score
    # owner rank per winner from the clump slab size (identical math on
    # every host)
    n_clumps = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    slab = -(-n_clumps // nprocs)
    owner = (refpos // VECSZ) // slab
    g = [np.asarray(mhu.process_allgather(x))
         for x in (ed_l, gq_l, gr_l, fp_l, sc_l)]
    idx = np.arange(nw)
    out_ed = g[0][owner, idx]
    gap_q = g[1][owner, idx]
    gap_r = g[2][owner, idx]
    fpos = g[3][owner, idx]
    score = g[4][owner, idx]
    if pod_order is not None:
        srt = pod_order
    else:
        clump = refpos // VECSZ
        lane = refpos % VECSZ
        srt = np.lexsort((-lane, -juni, -clump))
    return engine.Pods(
        six=qd.six[juni][srt], juni=juni[srt], refpos=refpos[srt],
        ed=out_ed[srt], rc=qd.rc[juni][srt], gap_q=gap_q[srt],
        gap_r=gap_r[srt], final_pos=fpos[srt], score=score[srt])


def _mh_rescore_fn(u_lo: int, u_hi: int, nprocs: int):
    """engine.rescore_winners drop-in whose phase B is owner-local and
    whose stats merge is the pod-consolidation gather (ANY reporters)."""
    def fn(qd, rd, juni, refpos, eds, mode, smat):
        return _rescore_multihost(qd, rd, juni, refpos, eds, mode,
                                  smat, None, u_lo, u_hi, nprocs)
    return fn


def _prepass_multihost(qd, rd, a, taxonomy, smat, pid: int, nprocs: int,
                       u_lo: int, u_hi: int, n_clumps: int, c_lo: int,
                       c_hi: int) -> int:
    """-p under DB shards: the scour merges per-shard candidate lists
    under the global first-touch key, the bounded DP runs owner-local
    with a min-merge, and the sequential emulation replays identically
    on every host (burst.c:3697-3992; process 0 writes)."""
    from ..accel import read_acx
    from ..prepass import run_prepass

    if not a["accel"]:
        print("ERROR: prepass requires an accelerator (-a)")
        return 1
    acc = read_acx(a["accel"], z_required=a["z"],
                   clump_range=(c_lo, c_hi))
    a = dict(a)
    a["smat"] = smat
    a["_top_lists_fn"] = _mh_top_lists
    a["_pairs_ed_fn"] = _mh_pairs_ed(u_lo, u_hi)
    # clump print lengths: sharded .edx reads leave non-local unit lens
    # 0, so take the elementwise max across hosts (clumps are wholly
    # owned, burst.c:2690-2699)
    from jax.experimental import multihost_utils as mhu
    ulens = rd.lens[rd.ix_srt[: rd.tot_units]].astype(np.int64)
    cl = np.zeros(n_clumps, dtype=np.int64)
    if rd.tot_units:
        np.maximum.at(cl, np.arange(rd.tot_units) // VECSZ, ulens)
    a["_clump_len"] = np.asarray(mhu.process_allgather(cl)).max(axis=0)
    out_path = a["out"] if pid == 0 else os.devnull
    with open(out_path, "w") as fh:
        return run_prepass(qd, rd, acc, a, fh, taxonomy)


def _mh_top_lists(qd, qk, acc, k: int, iters: int, nu: int,
                  do_rc: bool, n_clumps: int):
    """Per-query-strand top-ITER lists from per-host posting shards.

    Each host scours its local postings; candidates are allgathered and
    re-ordered by the global first-touch key (first word occurrence,
    clump id) -- clump slabs are disjoint, so hit counts concatenate
    without summing (see prepass._clump_hits on why the key equals the
    single-index stream order)."""
    from ..prepass import _clump_hits, _scour_words, _topsort

    nstr = 2 if do_rc else 1
    gids, cands, hits, fws = [], [], [], []
    for i in range(nu):
        for s in range(nstr):
            seq = qd.seqs[i] if s == 0 else qk.seqs[nu + i]
            c, h, fw = _clump_hits(acc, _scour_words(seq, k), n_clumps)
            gids.append(np.full(len(c), i * nstr + s, dtype=np.int64))
            cands.append(c)
            hits.append(h)
            fws.append(fw)
    z0 = np.zeros(0, np.int64)
    gi = np.concatenate(gids) if gids else z0
    ca = np.concatenate(cands) if cands else z0
    hi = np.concatenate(hits) if hits else z0
    fw = np.concatenate(fws) if fws else z0
    parts = _gather_concat([gi, ca, hi, fw])
    gi, ca, hi, fw = (np.concatenate(p) for p in parts)
    so = np.lexsort((ca, fw, gi))
    gi, ca, hi = gi[so], ca[so], hi[so]
    FM = np.zeros((nu, iters), dtype=np.int64)
    FI = np.zeros((nu, iters), dtype=np.int64)
    RM = np.zeros((nu, iters), dtype=np.int64)
    RI = np.zeros((nu, iters), dtype=np.int64)
    bounds = np.searchsorted(gi, np.arange(nu * nstr + 1))
    for g in range(nu * nstr):
        lo, hi_b = int(bounds[g]), int(bounds[g + 1])
        M, Ix = _topsort(ca[lo:hi_b], hi[lo:hi_b], iters)
        i, s = divmod(g, nstr)
        if s == 0:
            FM[i], FI[i] = M, Ix
        else:
            RM[i], RI[i] = M, Ix
    return FM, FI, RM, RI


def _mh_pairs_ed(u_lo: int, u_hi: int):
    """prepass pair-ED hook: owner-local exact DP + elementwise
    min-merge (the pair list is identical on every host)."""
    def pairs_ed(qk, rd, pj, pp, smat):
        from .. import engine

        pe = np.full(len(pj), 255, dtype=np.int64)
        local = (pp >= u_lo) & (pp < u_hi)
        if local.any():
            pe[local] = engine._pairs_min_ed(qk, rd, pj[local],
                                             pp[local], smat)
        return _gather_min(pe)
    return pairs_ed
