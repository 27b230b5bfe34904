"""Device-side k-mer scour: the accelerator candidate scan as one jit.

Accelerator re-expression of the reference's postScour walk
(/root/reference/burst.c:3238-3285) and candidate selection
(/root/reference/burst.c:4091-4136) for the single-member-bunch case
(QBUNCH=1, clear queries): instead of the host walking per-word postings
lists, every (query, k-mer-window) pair expands its unit postings into a
fixed-width slot matrix, and one row sort + segmented scans recover

* per-unit hit counts          (the sound per-unit pigeonhole filter),
* per-clump hit counts         (distinct-word contributions, matching
                                the native scour's transition walk),
* per-clump first-touch key    (min hitting word value; candidate order
                                is (hits desc, min-word asc, clump asc),
                                identical to the reference's walk order
                                because postings ascend within a word).

Winners are compacted on device into fixed buffers so one host fetch
returns everything. Rows whose postings exceed the slot budget are
flagged and re-scoured on the host (exact same results, just slower).

Preconditions (enforced by the caller in engine.accel_candidates):
QBUNCH == 1, rows are clear (pure ACGT), and the unit index exists
with clump-grouped ascending postings. Word lookup uses a dense rank
table up to k=13 and on-device binary search for k=14/15.
"""
from __future__ import annotations

import functools

import numpy as np

from .. import devtime

VECSZ = 16
DEAD = np.int32(2**31 - 1)   # sort sentinel (x64 is disabled in JAX)


class ScourOverflow(RuntimeError):
    """A chunk's compacted winner buffers overflowed (after the
    capacity escalation): the caller re-scours on the host."""


def _segmented_min(values, starts):
    """Per-position running min since the last True in `starts` (axis 1)."""
    import jax
    import jax.numpy as jnp

    def op(a, b):
        v1, s1 = a
        v2, s2 = b
        return (jnp.where(s2, v2, jnp.minimum(v1, v2)), s1 | s2)

    out, _ = jax.lax.associative_scan(op, (values, starts), axis=1)
    return out


def _segmented_max(values, starts):
    import jax
    import jax.numpy as jnp

    def op(a, b):
        v1, s1 = a
        v2, s2 = b
        return (jnp.where(s2, v2, jnp.maximum(v1, v2)), s1 | s2)

    out, _ = jax.lax.associative_scan(op, (values, starts), axis=1)
    return out


def _scour_core(qmat, lens, rank, nzw, start, cnt, ids, mm_member,
                mm_inner, k: int, E: int, CAPC: int, CAPU: int,
                n_clumps: int, tot_units: int):
    import jax.numpy as jnp
    import jax

    n, L = qmat.shape
    T = L - k + 1
    q = qmat.astype(jnp.int32) - 1
    w = jnp.zeros((n, T), jnp.int32)
    for i in range(k):                       # w_t = sum q[t+i] 4(k-1-i)
        w = w * 4 + q[:, i: i + T]           # k <= 15: fits int32
    valid_t = jnp.arange(T)[None, :] <= (lens - k)[:, None]
    if nzw is None:                          # dense rank table (k<=13)
        r = rank[jnp.clip(w, 0, rank.shape[0] - 1)].astype(jnp.int32)
    else:                                    # binary search (k=14/15)
        loc = jnp.searchsorted(nzw, w).astype(jnp.int32)
        locc = jnp.minimum(loc, nzw.shape[0] - 1)
        r = jnp.where(nzw[locc] == w, locc + 1, 0)
    s = start[r]
    c = jnp.where(valid_t, cnt[r], 0).astype(jnp.int32)
    cum = jnp.cumsum(c, axis=1)
    total = cum[:, -1]
    ov = total > E

    e = jnp.broadcast_to(jnp.arange(E, dtype=jnp.int32)[None, :], (n, E))
    # slot -> window mapping: te[j,e] = #{t : cum[j,t] <= e} (the
    # owning window), prev = the owning window's preceding cumsum,
    # ws/wv = its postings start and word value. A fori_loop over the
    # T windows, not an unrolled Python loop: the unrolled form emits
    # ~10 ops per window on [n, E] operands, and its compile time grows
    # with T*E (E=3072 at the shotgun shape). A batched searchsorted is
    # the other lowering; which is faster on the GPU is not measured.

    def _owner(t, carry):
        te, prev, ws, wv, c0 = carry
        ct = jax.lax.dynamic_slice_in_dim(cum, t, 1, 1)       # [n, 1]
        inside = ct <= e
        te = te + inside.astype(jnp.int32)
        prev = jnp.where(inside, ct, prev)
        hit = (c0 <= e) & (e < ct)      # slot owned by window t
        ws = jnp.where(hit, jax.lax.dynamic_slice_in_dim(s, t, 1, 1),
                       ws)
        wv = jnp.where(hit, jax.lax.dynamic_slice_in_dim(w, t, 1, 1),
                       wv)
        return te, prev, ws, wv, ct

    z = jnp.zeros((n, E), jnp.int32)
    te, prev, ws, wv, _ = jax.lax.fori_loop(
        0, T, _owner, (z, z, z, z, jnp.zeros((n, 1), jnp.int32)))
    live = e < jnp.minimum(total, E)[:, None]
    pos = jnp.where(live, ws + (e - prev), 0)
    u = ids[pos].astype(jnp.int32)
    return _scour_reduce(u, te, wv, None, live, ov, mm_member,
                         mm_inner, CAPC, CAPU)


def _scour_reduce(u, te, wv, wg, live, ov, mm_member, mm_inner,
                  CAPC: int, CAPU: int):
    """Shared scour tail: expanded slots (unit u, owning window te,
    word value wv, live mask) -> compacted clump candidates + passing
    unit keys. wg=None means unit weights (the per-query frontend);
    with wg each slot carries its word's weight, implementing the
    bunch MAX-multiplicity contribution (burst.c:3258-3284)."""
    import jax
    import jax.numpy as jnp

    n, E = u.shape
    cl = u // VECSZ
    # first slot of each (window, clump) run in expansion order: the
    # native walk adds the word weight once per clump transition
    same = (te[:, 1:] == te[:, :-1]) & (cl[:, 1:] == cl[:, :-1])
    mask_new = jnp.concatenate(
        [jnp.ones((n, 1), bool), ~same], axis=1) & live

    # lexicographic (unit, word*2|mask) sort; 64-bit packing is
    # unavailable (x64 disabled), lax.sort multi-key is exact
    key1 = jnp.where(live, u, DEAD)
    key2 = jnp.where(live, (wv << 1) | mask_new, DEAD)
    if wg is None:
        su, sk2 = jax.lax.sort((key1, key2), dimension=1, num_keys=2)
        swg = None
    else:
        su, sk2, swg = jax.lax.sort((key1, key2, wg), dimension=1,
                                    num_keys=2)
    slive = su < DEAD
    sw = sk2 >> 1
    sm = sk2 & 1
    scl = su // VECSZ
    idx = jnp.broadcast_to(jnp.arange(E, dtype=jnp.int32)[None, :], (n, E))

    u_start = jnp.concatenate(
        [jnp.ones((n, 1), bool), su[:, 1:] != su[:, :-1]], 1) & slive
    u_end = jnp.concatenate(
        [su[:, 1:] != su[:, :-1], jnp.ones((n, 1), bool)], 1) & slive
    if swg is None:
        # "last run start at or before me" is a plain running max of
        # the start positions (single-operand cummax beats tuple scan)
        last_ustart = jax.lax.cummax(jnp.where(u_start, idx, -1), axis=1)
        uh = idx - last_ustart + 1                    # run len at ends
    else:
        swg_l = jnp.where(slive, swg, 0)
        ucum = jnp.cumsum(swg_l, axis=1)
        uzst = jax.lax.cummax(
            jnp.where(u_start, ucum - swg_l, -1), axis=1)
        uh = ucum - uzst                              # weighted run sum

    cl_start = jnp.concatenate(
        [jnp.ones((n, 1), bool), scl[:, 1:] != scl[:, :-1]], 1) & slive
    cl_end = jnp.concatenate(
        [scl[:, 1:] != scl[:, :-1], jnp.ones((n, 1), bool)], 1) & slive
    # run hit total at the run end = cmask[end] - cmask[start - 1];
    # cmask is nondecreasing, so the run-start baseline propagates as a
    # running max of (cmask - sm) sampled at starts -- no gathers
    smw = sm if swg is None else sm * swg
    cmask = jnp.cumsum(smw, axis=1)
    zstart = jax.lax.cummax(
        jnp.where(cl_start, cmask - smw, -1), axis=1)
    hits_cl = cmask - zstart
    if swg is not None:
        # the native walk saturates the accumulated hits at 0xFFFF;
        # positive weights make the final clamp equivalent
        hits_cl = jnp.minimum(hits_cl, 0xFFFF)
    minw = _segmented_min(jnp.where(slive, sw, DEAD), cl_start)

    okrow = ~ov[:, None]
    cwin = cl_end & (hits_cl > mm_member[:, None]) & okrow
    uwin = u_end & (uh > mm_inner[:, None]) & okrow

    jrow = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[:, None], (n, E))

    def compact(mask, cols, cap):
        """Masked elements, in order, in fixed [cap] buffers.

        Two lowerings (BURST_TPU_COMPACT, trace-time): 'sort' (default)
        orders a position key with the columns as sort payloads --
        winners keep their flat position, losers get M and sink to the
        tail; 'scatter' writes through a cumsum target index. Both are
        exact; which is faster on the GPU is not measured."""
        import os
        flat = mask.ravel()
        M = flat.shape[0]
        if os.environ.get("BURST_TPU_COMPACT", "sort") == "sort":
            key = jnp.where(flat, jnp.arange(M, dtype=jnp.int32),
                            jnp.int32(M))
            srt = jax.lax.sort(
                (key,) + tuple(c.ravel() for c in cols), dimension=0,
                num_keys=1)
            count = jnp.sum(flat.astype(jnp.int32))
            live = jnp.arange(cap, dtype=jnp.int32) < count
            outs = [jnp.where(live, o[:cap], 0) for o in srt[1:]]
            return count, outs
        tgt = jnp.where(flat, jnp.cumsum(flat) - 1, cap)
        outs = [jnp.zeros((cap,), c.dtype).at[tgt].set(
            jnp.where(flat, c.ravel(), 0), mode="drop") for c in cols]
        return jnp.sum(flat.astype(jnp.int32)), outs

    ccount, (cj, ccl, chits, cminw) = compact(
        cwin, [jrow, scl, hits_cl, minw], CAPC)
    ucount, (uj, uu) = compact(uwin, [jrow, su], CAPU)
    return ov, ccount, cj, ccl, chits, cminw, ucount, uj, uu


@functools.partial(
    __import__("jax").jit,
    static_argnames=("k", "E", "CAPC", "CAPU", "n_clumps", "tot_units"))
def _scour_jit(qmat_full, lens_full, mm_m_full, mm_i_full, off,
               rank, nzw, start, cnt, ids,
               k: int, E: int, CAPC: int, CAPU: int,
               n_clumps: int, tot_units: int):
    import jax
    C = CHUNK_ROWS
    qmat = _unpack_codes(
        jax.lax.dynamic_slice_in_dim(qmat_full, off, C, 0))
    lens = jax.lax.dynamic_slice_in_dim(lens_full, off, C, 0)
    mm_member = jax.lax.dynamic_slice_in_dim(mm_m_full, off, C, 0)
    mm_inner = jax.lax.dynamic_slice_in_dim(mm_i_full, off, C, 0)
    return _scour_core(qmat, lens, rank, nzw, start, cnt, ids,
                       mm_member, mm_inner, k, E, CAPC, CAPU, n_clumps,
                       tot_units)


def _scour_core_words(wmat, nw, wgt, rank, nzw, start, cnt, ids,
                      mm_member, mm_inner, E: int, CAPC: int,
                      CAPU: int):
    """Scour over explicit per-row word lists with per-word weights
    (the QBUNCH>1 bunch scour: one row per bunch, words deduped with
    MAX multiplicity across members, burst.c:4096-4119). Same slot
    expansion as _scour_core, but the ownership sweep runs as a
    fori_loop -- T here is the deduped bunch word count (up to
    qbunch x windows), so the unrolled form would blow up compiles."""
    import jax
    import jax.numpy as jnp

    n, T = wmat.shape
    w = wmat
    valid_t = jnp.arange(T)[None, :] < nw[:, None]
    if nzw is None:                          # dense rank table (k<=13)
        r = rank[jnp.clip(w, 0, rank.shape[0] - 1)].astype(jnp.int32)
    else:                                    # binary search (k=14/15)
        loc = jnp.searchsorted(nzw, w).astype(jnp.int32)
        locc = jnp.minimum(loc, nzw.shape[0] - 1)
        r = jnp.where(nzw[locc] == w, locc + 1, 0)
    s = start[r]
    c = jnp.where(valid_t, cnt[r], 0).astype(jnp.int32)
    cum = jnp.cumsum(c, axis=1)
    total = cum[:, -1]
    ov = total > E
    e = jnp.broadcast_to(jnp.arange(E, dtype=jnp.int32)[None, :], (n, E))

    def body(t, carry):
        te, prev, ws, wv, wg, c0 = carry
        ct = jax.lax.dynamic_slice_in_dim(cum, t, 1, 1)       # [n, 1]
        inside = (ct <= e).astype(jnp.int32)
        te = te + inside
        prev = jnp.where(inside.astype(bool), ct, prev)
        hit = (c0 <= e) & (e < ct)          # slot owned by word t
        ws = jnp.where(hit, jax.lax.dynamic_slice_in_dim(s, t, 1, 1),
                       ws)
        wv = jnp.where(hit, jax.lax.dynamic_slice_in_dim(w, t, 1, 1),
                       wv)
        wg = jnp.where(hit, jax.lax.dynamic_slice_in_dim(wgt, t, 1, 1),
                       wg)
        return te, prev, ws, wv, wg, ct

    z = jnp.zeros((n, E), jnp.int32)
    te, prev, ws, wv, wg, _ = jax.lax.fori_loop(
        0, T, body, (z, z, z, z, z, jnp.zeros((n, 1), jnp.int32)))
    live = e < jnp.minimum(total, E)[:, None]
    pos = jnp.where(live, ws + (e - prev), 0)
    u = ids[pos].astype(jnp.int32)
    return _scour_reduce(u, te, wv, wg, live, ov, mm_member, mm_inner,
                         CAPC, CAPU)


@functools.partial(
    __import__("jax").jit,
    static_argnames=("C", "E", "CAPC", "CAPU"))
def _scour_words_jit(wmat_full, wgt_full, nw_full, mm_m_full,
                     mm_i_full, off, rank, nzw, start, cnt, ids,
                     C: int, E: int, CAPC: int, CAPU: int):
    import jax
    wmat = jax.lax.dynamic_slice_in_dim(wmat_full, off, C, 0)
    wgt = jax.lax.dynamic_slice_in_dim(wgt_full, off, C, 0)
    nw = jax.lax.dynamic_slice_in_dim(nw_full, off, C, 0)
    mm_member = jax.lax.dynamic_slice_in_dim(mm_m_full, off, C, 0)
    mm_inner = jax.lax.dynamic_slice_in_dim(mm_i_full, off, C, 0)
    return _scour_core_words(wmat, nw, wgt, rank, nzw, start, cnt, ids,
                             mm_member, mm_inner, E, CAPC, CAPU)


CHUNK_BUNCH = int(__import__("os").environ.get(
    "BURST_TPU_SCOUR_BCHUNK", 512))


def scour_bunch_rows(wmat: np.ndarray, wgt: np.ndarray,
                     nwords: np.ndarray, mm_bunch: np.ndarray,
                     mm_uinner: np.ndarray, tabs: "ScourTables",
                     tot_units: int, E: int | None = None,
                     defer: bool = False):
    """Scour `nB` bunch word-list rows on device.

    wmat/wgt: [nB, T] int32 word values / MAX-multiplicity weights,
    packed left; nwords: per-row word counts. Returns (like scour_rows)
    a dict with `ov` [nB], candidate tuples `cj` (bunch row) / `ccl` /
    `chits` / `cminw`, and `ukeys` = bunchrow*tot_units + unit for
    units passing hits > mm_uinner (callers expand or ignore them).
    """
    import os

    import jax.numpy as jnp

    if E is None:
        E = int(os.environ.get("BURST_TPU_SCOUR_EB", 4096))
    nB, T = wmat.shape
    C = CHUNK_BUNCH
    Tp = -(-max(T, 1) // 128) * 128
    npad = max(C, -(-nB // C) * C)
    factor = getattr(tabs, "cap_factor", 2)

    def dispatch(fac):
        capc = capu = fac * C
        wp = np.zeros((npad, Tp), dtype=np.int32)
        wp[:nB, :T] = wmat
        gp = np.ones((npad, Tp), dtype=np.int32)
        gp[:nB, :T] = wgt
        nwp = np.zeros(npad, dtype=np.int32)
        nwp[:nB] = nwords
        mmm = np.full(npad, DEAD, dtype=np.int32)
        mmm[:nB] = np.minimum(mm_bunch, DEAD - 1)
        mmi = np.full(npad, DEAD, dtype=np.int32)
        mmi[:nB] = np.minimum(mm_uinner, DEAD - 1)
        wp_d = jnp.asarray(wp)
        gp_d = jnp.asarray(gp)
        nw_d = jnp.asarray(nwp)
        mmm_d = jnp.asarray(mmm)
        mmi_d = jnp.asarray(mmi)
        out = []
        for c0 in range(0, npad, C):
            nr = min(C, max(0, nB - c0))
            res = _scour_words_jit(
                wp_d, gp_d, nw_d, mmm_d, mmi_d, jnp.int32(c0),
                tabs.rank, tabs.nzw, tabs.start, tabs.cnt, tabs.ids,
                C=C, E=E, CAPC=capc, CAPU=capu)
            out.append((c0, nr, res))
        return out

    chunks = dispatch(factor)

    def finish():
        try:
            return _chunk_finish_bunch(chunks, nB, tot_units, factor, C)
        except ScourOverflow:
            if factor >= 4:
                raise
            tabs.cap_factor = 4
            return _chunk_finish_bunch(dispatch(4), nB, tot_units, 4, C)

    return finish if defer else finish()


def _chunk_finish_bunch(chunks, n, tot_units, cap_factor: int, C: int):
    """One device_get over bunch chunks (scour-only _chunk_finish with
    the bunch chunk width)."""
    import jax

    capc = capu = cap_factor * C
    fetched = devtime.fetch([r for _, _, r in chunks])
    ov = np.zeros(n, dtype=bool)
    parts = {key: [] for key in ("cj", "ccl", "chits", "cminw",
                                 "ukeys")}
    for (c0, nr, _), h in zip(chunks, fetched):
        (ovc, ccount, cj, ccl, chits, cminw, ucount, uj, uu) = h
        nc, nu = int(ccount), int(ucount)
        if nc > capc or nu > capu:
            raise ScourOverflow("device scour buffer overflow")
        ov[c0:c0 + nr] = ovc[:nr]
        parts["cj"].append(cj[:nc].astype(np.int64) + c0)
        parts["ccl"].append(ccl[:nc].astype(np.int64))
        parts["chits"].append(chits[:nc].astype(np.int64))
        parts["cminw"].append(cminw[:nc].astype(np.int64))
        parts["ukeys"].append(
            (uj[:nu].astype(np.int64) + c0) * tot_units
            + uu[:nu].astype(np.int64))
    out = {"ov": ov}
    for key in ("cj", "ccl", "chits", "cminw", "ukeys"):
        out[key] = np.concatenate(parts[key]) if parts[key] \
            else np.zeros(0, np.int64)
    return out


def _build_peq_dev(qmat, lens, smat_dev, W: int):
    """Device Peq planes: [n, 16, W] uint32, rows >= len are wildcards
    (same semantics as kernels/myers.build_peq)."""
    import jax.numpy as jnp
    n = qmat.shape[0]
    m_pad = 32 * W
    q = qmat[:, :m_pad]
    match = smat_dev[q.astype(jnp.int32)] == 0          # [n, m_pad, 16]
    pad_row = jnp.arange(m_pad)[None, :] >= lens[:, None]
    match = match | pad_row[:, :, None]
    bits = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    mm = match.reshape(n, W, 32, 16).astype(jnp.uint32) \
        * bits[None, None, :, None]
    return mm.sum(axis=2, dtype=jnp.uint32).transpose(0, 2, 1)


def _unpack_codes(packed):
    """[n, L/2] two-codes-per-byte -> [n, L] 4-bit codes (upload is
    half the bytes)."""
    import jax.numpy as jnp
    n, Lh = packed.shape
    lo = packed & jnp.uint8(0xF)
    hi = packed >> jnp.uint8(4)
    return jnp.stack([lo, hi], axis=2).reshape(n, 2 * Lh)


@functools.partial(
    __import__("jax").jit, static_argnames=("W", "POW2"))
def _peq_pow2_jit(qmat_full, lens_full, smat_dev, W: int, POW2: int):
    """Whole-batch Peq planes padded to a pow2 row count -- the exact
    array engine._peq_device would upload, built from the batch matrix
    already on device (saves the host build + ~5MB transfer)."""
    import jax.numpy as jnp
    peq = _build_peq_dev(_unpack_codes(qmat_full), lens_full, smat_dev,
                         W)
    pad = POW2 - qmat_full.shape[0]
    if pad > 0:
        peq = jnp.concatenate(
            [peq, jnp.zeros((pad, 16, W), jnp.uint32)])
    return peq


@functools.partial(
    __import__("jax").jit,
    static_argnames=("k", "E", "CAPC", "CAPU", "n_clumps", "tot_units",
                     "W", "Lp"))
def _scour_align_jit(qmat_full, lens_full, mm_m_full, mm_i_full,
                     off, rank, nzw, start, cnt, ids, smat_dev,
                     tiles_packed,
                     k: int, E: int, CAPC: int, CAPU: int,
                     n_clumps: int, tot_units: int, W: int, Lp: int):
    """Fused scour + phase-A Myers: winners go straight into the pair
    kernel on device; one fetch returns candidates, unit winners, and
    their packed (ed, first, last) results. The chunk slices out of the
    whole-batch arrays on device (one upload, one compile per padded
    batch shape). tiles_packed holds ALL units (row == sorted
    position) as packed words of logical width Lp -- trailing pad
    columns never lower the glocal minimum, so per-pair min EDs equal
    the per-bucket scans'."""
    import jax
    import jax.numpy as jnp

    from ..engine import _myers_pairs_dispatch_packed

    C = CHUNK_ROWS
    qmat = _unpack_codes(
        jax.lax.dynamic_slice_in_dim(qmat_full, off, C, 0))
    lens = jax.lax.dynamic_slice_in_dim(lens_full, off, C, 0)
    mm_member = jax.lax.dynamic_slice_in_dim(mm_m_full, off, C, 0)
    mm_inner = jax.lax.dynamic_slice_in_dim(mm_i_full, off, C, 0)
    (ov, ccount, cj, ccl, chits, cminw, ucount, uj,
     uu) = _scour_core(qmat, lens, rank, nzw, start, cnt, ids,
                       mm_member, mm_inner, k, E, CAPC, CAPU,
                       n_clumps, tot_units)
    peq = _build_peq_dev(qmat, lens, smat_dev, W)
    tidx = jnp.clip(uu, 0, tot_units - 1)
    packed = _myers_pairs_dispatch_packed(peq, tiles_packed, Lp, uj,
                                          tidx, W)
    if Lp < 2047:
        # (ed, first, last) fit 8+11+11 bits: one fetch word per pair
        pk = (jnp.minimum(packed[0], 255) << 22) | \
            (packed[1] << 11) | packed[2]
        return (ov, ccount, cj, ccl, chits, cminw, ucount, uj, uu, pk)
    return ov, ccount, cj, ccl, chits, cminw, ucount, uj, uu, packed


class ScourTables:
    """Device-resident postings tables, built once per accelerator.

    k <= 13: dense word->rank table (one gather per window). k = 14/15
    (4^k too large to materialize): sorted nonzero words, looked up by
    binary search on device; words up to 4^15 fit int32."""

    def __init__(self, u_csr, span: int, dense: bool):
        import jax.numpy as jnp
        n_nz = len(u_csr.nzw)
        if dense:
            rank = np.zeros(span, dtype=np.int32)
            rank[u_csr.nzw] = np.arange(1, n_nz + 1, dtype=np.int32)
            self.rank = jnp.asarray(rank)
            self.nzw = None
        else:
            self.rank = jnp.zeros(1, jnp.int32)   # unused placeholder
            self.nzw = jnp.asarray(u_csr.nzw.astype(np.int32))
        start = np.zeros(n_nz + 1, dtype=np.int32)
        start[1:] = u_csr.start.astype(np.int32)
        cnt = np.zeros(n_nz + 1, dtype=np.int32)
        cnt[1:] = u_csr.cnt.astype(np.int32)
        self.start = jnp.asarray(start)
        self.cnt = jnp.asarray(cnt)
        self.ids = jnp.asarray(u_csr.ids.astype(np.int32))


_TABLES_LOCK = __import__("threading").Lock()


def get_tables(acc) -> "ScourTables | None":
    """Cached device tables; None when the index shape is unsupported.
    Locked: streaming worker threads may race the first build."""
    got = getattr(acc, "_dev_tables", None)
    if got is not None:
        return got
    if acc.k > 15 or acc.u_csr is None:
        return None
    if len(acc.u_csr.ids) >= 2**31:      # int32 postings offsets
        return None
    with _TABLES_LOCK:
        got = getattr(acc, "_dev_tables", None)
        if got is not None:
            return got
        span = 1 << (2 * acc.k)
        tabs = ScourTables(acc.u_csr, span, dense=acc.k <= 13)
        acc._dev_tables = tabs
    return tabs


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


CHUNK_ROWS = int(__import__("os").environ.get(
    "BURST_TPU_SCOUR_CHUNK", 4096))   # fixed jit shape: one compile


def _chunk_dispatch(qmat, lens, k, mm_member, mm_inner, tabs,
                    n_clumps, tot_units, E, align_ctx,
                    cap_factor: int = 2):
    """Dispatch the scour (or fused scour+align) jit over fixed-size
    row chunks; returns [(c0, rows_in_chunk, device_result), ...].

    The whole batch pads to a CHUNK_ROWS multiple and uploads once;
    each chunk slices out on device with a dynamic offset, so the
    kernel compiles once per padded batch shape and the transfer
    pipelines ahead of the first chunk's compute."""
    import jax.numpy as jnp

    n = len(lens)
    L = qmat.shape[1]
    C = CHUNK_ROWS
    npad = max(C, -(-n // C) * C)
    capc = capu = cap_factor * C
    qp = np.zeros((npad, L), dtype=np.uint8)
    qp[:n] = qmat
    lp = np.zeros(npad, dtype=np.int32)
    lp[:n] = lens
    mmm = np.full(npad, DEAD, dtype=np.int32)
    mmm[:n] = np.minimum(mm_member, DEAD - 1)
    mmi = np.full(npad, DEAD, dtype=np.int32)
    mmi[:n] = np.minimum(mm_inner, DEAD - 1)
    # two 4-bit codes per byte: halves the upload, unpacked on device
    qp_d = jnp.asarray(qp[:, 0::2] | (qp[:, 1::2] << 4))
    lp_d = jnp.asarray(lp)
    mmm_d = jnp.asarray(mmm)
    mmi_d = jnp.asarray(mmi)
    out = []
    for c0 in range(0, npad, C):
        nr = min(C, max(0, n - c0))
        if align_ctx is None:
            res = _scour_jit(
                qp_d, lp_d, mmm_d, mmi_d, jnp.int32(c0), tabs.rank,
                tabs.nzw, tabs.start, tabs.cnt, tabs.ids, k=k, E=E,
                CAPC=capc, CAPU=capu, n_clumps=n_clumps,
                tot_units=tot_units)
        else:
            smat_dev, (tiles_packed, Lp), W = align_ctx
            res = _scour_align_jit(
                qp_d, lp_d, mmm_d, mmi_d, jnp.int32(c0), tabs.rank,
                tabs.nzw, tabs.start, tabs.cnt, tabs.ids, smat_dev,
                tiles_packed, k=k, E=E, CAPC=capc, CAPU=capu,
                n_clumps=n_clumps, tot_units=tot_units, W=W, Lp=Lp)
        out.append((c0, nr, res))
    return out, qp_d, lp_d


def _chunk_finish(chunks, n, tot_units, aligned: bool,
                  cap_factor: int = 2):
    """One device_get over every chunk, merged to global row indices.
    Raises ScourOverflow when any chunk's winner buffers overflowed."""
    import jax

    capc = capu = cap_factor * CHUNK_ROWS
    fetched = devtime.fetch([r for _, _, r in chunks])
    ov = np.zeros(n, dtype=bool)
    parts = {key: [] for key in
             ("cj", "ccl", "chits", "cminw", "ukeys", "uj", "uu",
              "ped", "pfirst", "plast")}
    for (c0, nr, _), h in zip(chunks, fetched):
        if aligned:
            (ovc, ccount, cj, ccl, chits, cminw, ucount, uj, uu,
             packed) = h
        else:
            (ovc, ccount, cj, ccl, chits, cminw, ucount, uj, uu) = h
            packed = None
        nc, nu = int(ccount), int(ucount)
        if nc > capc or nu > capu:
            raise ScourOverflow("device scour buffer overflow")
        ov[c0:c0 + nr] = ovc[:nr]
        parts["cj"].append(cj[:nc].astype(np.int64) + c0)
        parts["ccl"].append(ccl[:nc].astype(np.int64))
        parts["chits"].append(chits[:nc].astype(np.int64))
        parts["cminw"].append(cminw[:nc].astype(np.int64))
        parts["ukeys"].append(
            (uj[:nu].astype(np.int64) + c0) * tot_units
            + uu[:nu].astype(np.int64))
        if aligned:
            parts["uj"].append(uj[:nu].astype(np.int64) + c0)
            parts["uu"].append(uu[:nu].astype(np.int64))
            if packed.ndim == 1:       # (ed<<22 | first<<11 | last)
                pk = packed[:nu].astype(np.int64)
                parts["ped"].append(pk >> 22)
                parts["pfirst"].append((pk >> 11) & 0x7FF)
                parts["plast"].append(pk & 0x7FF)
            else:
                parts["ped"].append(
                    np.minimum(packed[0][:nu].astype(np.int64), 255))
                parts["pfirst"].append(packed[1][:nu].astype(np.int64))
                parts["plast"].append(packed[2][:nu].astype(np.int64))
    out = {"ov": ov}
    keys = ("cj", "ccl", "chits", "cminw", "ukeys") + (
        ("uj", "uu", "ped", "pfirst", "plast") if aligned else ())
    for key in keys:
        out[key] = np.concatenate(parts[key]) if parts[key] \
            else np.zeros(0, np.int64)
    return out


def scour_rows(qmat: np.ndarray, lens: np.ndarray, k: int,
               mm_member: np.ndarray, mm_inner: np.ndarray,
               tabs: ScourTables, n_clumps: int, tot_units: int,
               E: int | None = None, defer: bool = False):
    """Scour `n` clear rows on device (fixed-size row chunks).

    Returns a `finish()` closure (defer=True) or its result: a dict with
    `ov` [n] bool overflow flags, `cj`/`ccl`/`chits`/`cminw` candidate
    tuples (hits > mm_member, unordered), and `ukeys` passing unit keys
    (ascending); per-chunk winner buffers overflowing raise
    ScourOverflow (caller falls back to the host scour).
    """
    import os

    if E is None:
        E = int(os.environ.get("BURST_TPU_SCOUR_E", 256))
    n = len(lens)
    factor = getattr(tabs, "cap_factor", 2)
    chunks, _, _ = _chunk_dispatch(qmat, lens, k, mm_member, mm_inner,
                                   tabs, n_clumps, tot_units, E, None,
                                   factor)

    def finish():
        try:
            return _chunk_finish(chunks, n, tot_units, aligned=False,
                                 cap_factor=factor)
        except ScourOverflow:
            if factor >= 4:
                raise
            # sticky escalation: this DB/workload needs bigger winner
            # buffers; redo once and remember for future batches
            tabs.cap_factor = 4
            ch2, _, _ = _chunk_dispatch(qmat, lens, k, mm_member,
                                        mm_inner, tabs, n_clumps,
                                        tot_units, E, None, 4)
            return _chunk_finish(ch2, n, tot_units, aligned=False,
                                 cap_factor=4)

    return finish if defer else finish()


def scour_align_rows(qmat: np.ndarray, lens: np.ndarray, k: int,
                     mm_member: np.ndarray, mm_inner: np.ndarray,
                     tabs: ScourTables, n_clumps: int, tot_units: int,
                     smat_dev, tiles_dev, W: int,
                     E: int | None = None):
    """Fused scour + phase-A pair alignment for `n` clear rows.

    Like scour_rows but the passing units are also aligned on device;
    the returned finish() additionally yields `uj`/`uu` pair arrays and
    `ped`/`pfirst`/`plast` per-pair packed Myers results.
    """
    import os

    if E is None:
        E = int(os.environ.get("BURST_TPU_SCOUR_E", 256))
    n = len(lens)
    factor = getattr(tabs, "cap_factor", 2)
    ctx = (smat_dev, tiles_dev, W)
    chunks, qp_d, lp_d = _chunk_dispatch(
        qmat, lens, k, mm_member, mm_inner, tabs, n_clumps, tot_units,
        E, ctx, factor)

    def finish():
        try:
            return _chunk_finish(chunks, n, tot_units, aligned=True,
                                 cap_factor=factor)
        except ScourOverflow:
            if factor >= 4:
                raise
            tabs.cap_factor = 4
            ch2, _, _ = _chunk_dispatch(qmat, lens, k, mm_member,
                                        mm_inner, tabs, n_clumps,
                                        tot_units, E, ctx, 4)
            return _chunk_finish(ch2, n, tot_units, aligned=True,
                                 cap_factor=4)

    finish.batch_dev = (qp_d, lp_d)
    return finish
