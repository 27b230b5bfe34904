"""Phase-B kernel: exact tie-aware rescoring DP (batched, JAX).

Reproduces the reference's reScoreM semantics
(/root/reference/burst.c:713-886) for a batch of (query, reference-tile)
winner pairs: per pair it returns the minimum glocal edit distance
together with the reference's dual-objective statistics:

  * gap_q / gap_r  -- query/reference gap counts of the winning path,
    chosen per cell by the exact tiebreak (min score; on ties, max gap_q),
    reported from the *earliest* last-row column attaining (min ED, max
    gap_q) -- matching the reference's sequential lane reduction;
  * final_pos      -- the *latest* last-row column attaining that pair
    (1-based reference end coordinate);
  * score          -- float32 identity 1 - ED/(qlen + gap_q), computed
    host-side so the float matches the reference's SSE division exactly.

Accelerator mapping: the scan runs over query rows; within a row the left-gap
chain (cur[x] = merge(base[x], cur[x-1] + (1,1,0)) with tiebreaks) is an
associative prefix selection over position-invariant keys
(score - x, gap_q - x, x). Both keys fit 13 bits each, so the pair packs
into one int32 compared lexicographically, and the scan is a log2(L)
Hillis-Steele sweep of compare+select -- no gathers, no tuple scans.
Cost rows are derived from the same Peq bit tables as the phase-A Myers
kernel (unit costs are always 0/1/dead), so there is no per-row table
gather either. Mixed query lengths use wildcard tail rows; the padding
shifts final_pos right by (m_pad - qlen), undone before returning.

Limits of the packed fast path: tile length <= 7679 columns and 32*W <=
256 query rows; longer inputs use a separate packing with int32 pairs
(two-array compare) -- still exact, just slower.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import score_matrix
from .myers import build_peq

DEAD = 511          # uniform "dead" score (reference: saturated 255)


def make_rescore(smat_np: np.ndarray):
    """Build a jitted rescore closed over a scoring matrix."""

    @functools.partial(jax.jit, static_argnames=("W", "levels", "rows"))
    def rescore_batch(peq, qlens, tiles, max_ed, W: int,
                      levels: int | None = None, rows: int | None = None):
        P, Lp = tiles.shape
        # wildcard tail rows carry row-qlen optima down unchanged, so
        # the scan may stop at the batch's max query length instead of
        # the full 32*W padding
        m_pad = W * 32 if rows is None else rows
        # key packing: 13+13-bit int32 keys cover Lp <= 7679 and
        # m_pad <= 511 (score <= DEAD+1 = 512, col-0 boundary <= m_pad,
        # shift-R counter <= m_pad in the 9-bit payload field); larger
        # shapes switch to 21+21-bit int64 keys -- same math, wider
        wide = not (Lp <= 7679 and m_pad <= 511)
        assert Lp < (1 << 20) and m_pad < (1 << 20), "rescore range"
        SH, PSH = 13, 9
        GMASK = (1 << SH) - 1
        PMASK = (1 << PSH) - 1
        L1 = Lp + 1
        bad = (max_ed + 1).astype(jnp.int32)[:, None]        # [P,1]
        xs = jnp.arange(L1, dtype=jnp.int32)[None, :]        # [1,L1]
        pad_col = (tiles == 0)                               # [P,Lp]

        # Eq bit columns from the Peq tables (match <=> unit cost 0)
        peq_t = jnp.transpose(peq, (1, 2, 0))                # [16,W,P]
        v = peq_t[:, :, :, None]
        colv = tiles.astype(jnp.int32)                       # [P,Lp]
        for kbit in range(int(np.log2(peq.shape[1]))):
            bit = ((colv >> kbit) & 1).astype(bool)          # [P,Lp]
            v = jnp.where(bit[None, None, :, :], v[1::2], v[0::2])
        eq_cols = v[0]                                       # [W,P,Lp]

        def cost_row(y):
            """Unit cost of query row y (1-based) vs every tile column."""
            w = (y - 1) // 32
            b = ((y - 1) % 32).astype(jnp.uint32) if hasattr(
                y, "aval") else jnp.uint32((y - 1) % 32)
            match = ((eq_cols[w] >> b) & jnp.uint32(1)
                     ).astype(bool)                          # [P,Lp]
            return jnp.where(match, 0,
                             jnp.where(pad_col, DEAD, 1)).astype(jnp.int32)

        offs = jnp.int32(Lp)                                 # key offset

        def pack(s, g, x):
            hi = (s - x + offs)
            lo = jnp.int32(GMASK) - (g - x + offs)
            return (hi << jnp.int32(SH)) | lo

        # --- row 1, special-cased exactly like the reference ---
        d1 = cost_row(1)
        sc = jnp.concatenate(
            [jnp.ones((P, 1), jnp.int32), d1], axis=1)       # [P,L1]
        left = sc[:, :-1]
        sh1 = ((d1 == 1) & (left == 0)).astype(jnp.int32)
        sh = jnp.concatenate([jnp.zeros((P, 1), jnp.int32), sh1], axis=1)
        shr = jnp.zeros((P, L1), jnp.int32).at[:, 0].set(1)
        sc = jnp.where(sc >= bad, DEAD, sc)

        neg_inf_key = jnp.int32((GMASK << SH) | GMASK)

        def row_step(carry, y):
            psc, psh, pshr = carry
            d = cost_row(y)
            # diagonal vs up (gap in reference) merge
            sO = jnp.minimum(psc[:, :-1] + d, DEAD + 1)
            sU = jnp.minimum(psc[:, 1:] + 1, DEAD + 1)
            gO, gU = psh[:, :-1], psh[:, 1:]
            takeU = (sU < sO) | ((sU == sO) & (gU > gO))
            bs = jnp.where(takeU, sU, sO)
            bg = jnp.where(takeU, gU, gO)
            br = jnp.where(takeU, pshr[:, 1:] + 1, pshr[:, :-1])
            # column-0 boundary (y, 0, y)
            ycol = jnp.full((P, 1), y, jnp.int32)
            bs = jnp.concatenate([ycol, bs], axis=1)
            bg = jnp.concatenate([jnp.zeros((P, 1), jnp.int32), bg], axis=1)
            br = jnp.concatenate([ycol, br], axis=1)
            # left-gap chain: prefix selection. Narrow shapes pack
            # (score, gapQ) into one int32 key and (x, shiftR) into one
            # int32 payload; wide shapes compare the four int32 planes
            # lexicographically (same order, no field-width limits).
            d_stop = L1 if levels is None else min(L1, 1 << levels)
            d_shift = 1
            if not wide:
                key = pack(jnp.minimum(bs, DEAD + 1), bg, xs)
                pay = ((xs * jnp.ones((P, 1), jnp.int32))
                       << jnp.int32(PSH)) | br
                while d_shift < d_stop:
                    kpad = jnp.full((P, d_shift), neg_inf_key, jnp.int32)
                    ppad = jnp.zeros((P, d_shift), jnp.int32)
                    ks = jnp.concatenate([kpad, key[:, :-d_shift]],
                                         axis=1)
                    ps = jnp.concatenate([ppad, pay[:, :-d_shift]],
                                         axis=1)
                    better = (ks < key) | ((ks == key) & (ps > pay))
                    key = jnp.where(better, ks, key)
                    pay = jnp.where(better, ps, pay)
                    d_shift <<= 1
                nsc = (key >> jnp.int32(SH)) - offs + xs
                nsh = (jnp.int32(GMASK) - (key & jnp.int32(GMASK))) \
                    - offs + xs
                nshr = pay & jnp.int32(PMASK)
            else:
                k_hi = jnp.minimum(bs, DEAD + 1) - xs
                k_lo = -(bg - xs)          # gapQ desc == -(g - x) asc
                p_x = xs * jnp.ones((P, 1), jnp.int32)
                p_br = br
                big = jnp.int32(1 << 30)

                def shl(a, d, fill):
                    head = jnp.full((P, d), fill, a.dtype)
                    return jnp.concatenate([head, a[:, :-d]], axis=1)

                while d_shift < d_stop:
                    s_hi = shl(k_hi, d_shift, big)
                    s_lo = shl(k_lo, d_shift, big)
                    s_x = shl(p_x, d_shift, jnp.int32(0))
                    s_br = shl(p_br, d_shift, jnp.int32(0))
                    better = (s_hi < k_hi) | (
                        (s_hi == k_hi) & ((s_lo < k_lo) | (
                            (s_lo == k_lo) & ((s_x > p_x) | (
                                (s_x == p_x) & (s_br > p_br))))))
                    k_hi = jnp.where(better, s_hi, k_hi)
                    k_lo = jnp.where(better, s_lo, k_lo)
                    p_x = jnp.where(better, s_x, p_x)
                    p_br = jnp.where(better, s_br, p_br)
                    d_shift <<= 1
                nsc = k_hi + xs
                nsh = -k_lo + xs
                nshr = p_br
            nsc = jnp.where(nsc >= bad, DEAD, nsc)
            nsc = nsc.at[:, 0].set(y)
            nsh = nsh.at[:, 0].set(0)
            nshr = nshr.at[:, 0].set(y)
            return (nsc, nsh, nshr), None

        (sc, sh, shr), _ = jax.lax.scan(
            row_step, (sc, sh, shr), jnp.arange(2, m_pad + 1, dtype=jnp.int32))

        # --- final lane reduction over columns 1..Lp ---
        s_last, g_last, r_last = sc[:, 1:], sh[:, 1:], shr[:, 1:]
        best_s = jnp.min(s_last, axis=1)
        is_min = s_last == best_s[:, None]
        best_g = jnp.max(jnp.where(is_min, g_last, -1), axis=1)
        is_best = is_min & (g_last == best_g[:, None])
        colix = jnp.arange(1, Lp + 1, dtype=jnp.int32)[None, :]
        first_col = jnp.min(jnp.where(is_best, colix, jnp.int32(1 << 30)),
                            axis=1)
        last_col = jnp.max(jnp.where(is_best, colix, 0), axis=1)
        best_r = jnp.take_along_axis(
            r_last, jnp.clip(first_col - 1, 0, Lp - 1)[:, None], axis=1)[:, 0]
        ed = jnp.minimum(best_s, 255)
        final_pos = last_col - (m_pad - qlens)
        return ed, best_g, best_r, final_pos

    return rescore_batch


_CACHE: dict[bytes, object] = {}
_GCACHE: dict[bytes, object] = {}


def make_rescore_gather(smat_np: np.ndarray):
    core = _CACHE.get(smat_np.tobytes())
    if core is None:
        core = _CACHE[smat_np.tobytes()] = make_rescore(smat_np)

    @functools.partial(jax.jit, static_argnames=("W", "levels", "rows"))
    def fn(peq_all, tiles_all, pidx, tidx, qlens, max_ed, W: int,
           levels: int | None = None, rows: int | None = None):
        peq = jnp.take(peq_all, pidx, axis=0)
        tiles = jnp.take(tiles_all, tidx, axis=0)
        return jnp.stack(core(peq, qlens, tiles, max_ed, W, levels, rows))

    @functools.partial(jax.jit,
                       static_argnames=("W", "levels", "rows", "Lw"))
    def fn_win(peq_all, tiles_all, pidx, tidx, qlens, max_ed, x0,
               W: int, Lw: int, levels: int | None = None,
               rows: int | None = None):
        peq = jnp.take(peq_all, pidx, axis=0)
        tiles = jnp.take(tiles_all, tidx, axis=0)
        win = _window_tiles(tiles, x0, Lw)
        return jnp.stack(core(peq, qlens, win, max_ed, W, levels, rows))

    return fn, fn_win


def _window_tiles(tiles, x0, Lw: int):
    """Slice [B, Lw-1] column windows starting at x0 (device gather).

    Indices past the tile end clamp to the last column, which is always
    a pad (code 0 -> DEAD cost): window width never exceeds the tiles'
    built-in trailing pad (see engine.rescore_winners window math).
    """
    idx = x0[:, None] + jnp.arange(Lw - 1, dtype=jnp.int32)[None, :]
    idx = jnp.clip(idx, 0, tiles.shape[1] - 1)
    return jnp.take_along_axis(tiles, idx, axis=1)


def _levels_for(max_ed: np.ndarray) -> int:
    """Hillis-Steele doublings covering a max(max_ed)+1 look-back window."""
    need = int(max_ed.max()) + 2 if len(max_ed) else 2
    lv = 1
    while (1 << lv) < need:
        lv += 1
    return lv


def rescore_pairs_gather_async(peq_all, tiles_all, pidx, tidx, qlens,
                               max_ed, W: int, smat: np.ndarray,
                               x0: np.ndarray | None = None,
                               Lw: int | None = None):
    """Dispatch a device-gather rescore chunk; returns device arrays.

    Finalize with `rescore_finalize` after all chunks are dispatched so
    syncs pipeline instead of serializing on device round-trips. This
    is XLA's scan on every platform (no hand-written kernel).

    With `x0`/`Lw` set, the DP runs on per-pair [Lw-1]-column windows of
    the gathered tiles starting at column offset x0 (0-based array
    index). The caller guarantees the window covers every minimum-ED
    last-row column and every min-cost path reaching one (see
    engine.rescore_winners); returned final_pos is window-local --
    add x0 back on the host.
    """
    rows = min(W * 32, int(-(-int(qlens.max()) // 8)) * 8) if len(qlens) \
        else W * 32
    key = smat.tobytes()
    fns = _GCACHE.get(key)
    if fns is None:
        fns = _GCACHE[key] = make_rescore_gather(smat)
    fn, fn_win = fns
    if x0 is not None:
        return fn_win(peq_all, tiles_all,
                      jnp.asarray(pidx.astype(np.int32)),
                      jnp.asarray(tidx.astype(np.int32)),
                      jnp.asarray(qlens.astype(np.int32)),
                      jnp.asarray(max_ed.astype(np.int32)),
                      jnp.asarray(x0.astype(np.int32)), W, Lw,
                      _levels_for(max_ed), rows)
    return fn(peq_all, tiles_all, jnp.asarray(pidx.astype(np.int32)),
              jnp.asarray(tidx.astype(np.int32)),
              jnp.asarray(qlens.astype(np.int32)),
              jnp.asarray(max_ed.astype(np.int32)), W,
              _levels_for(max_ed), rows)


def rescore_finalize_host(ed, gq, gr, fp, qlens: np.ndarray):
    """Float32 identity on already-fetched arrays (burst.c:844-860
    semantics, with the shipped binary's -Ofast reciprocal rounding)."""
    from ..native import score_identity
    score = score_identity(ed.astype(np.float32),
                           (qlens.astype(np.int64) + gq
                            ).astype(np.float32))
    return ed, gq, gr, fp, score


def rescore_finalize(out, qlens: np.ndarray):
    """Host conversion + float32 identity. Prefer fetching many chunks
    with one jax.device_get and calling rescore_finalize_host: each
    separate device->host conversion is its own round trip. `out` is a
    packed [4, N] array (gather paths) or a 4-tuple (direct core
    calls)."""
    if isinstance(out, tuple):
        ed, gq, gr, fp = (np.asarray(o) for o in out)
    else:
        out = np.asarray(out)
        ed, gq, gr, fp = out[0], out[1], out[2], out[3]
    return rescore_finalize_host(ed, gq, gr, fp, qlens)


def rescore_pairs_gather(peq_all, tiles_all, pidx, tidx, qlens, max_ed,
                         W: int, smat: np.ndarray):
    """Device-gather rescore: peq_all/tiles_all stay device-resident."""
    out = rescore_pairs_gather_async(peq_all, tiles_all, pidx, tidx,
                                     qlens, max_ed, W, smat)
    return rescore_finalize(out, qlens)


def rescore_pairs(queries: np.ndarray | None, qlens: np.ndarray,
                  tiles: np.ndarray, max_ed: np.ndarray, W: int,
                  smat: np.ndarray | None = None,
                  peq: np.ndarray | None = None):
    """Host wrapper: Peq prep, jit cache per scoring matrix, float score.

    Pass precomputed `peq` (from myers.build_peq) to skip the host-side
    table build; `queries` may then be None.
    """
    if smat is None:
        smat = score_matrix()
    key = smat.tobytes()
    fn = _CACHE.get(key)
    if fn is None:
        fn = _CACHE[key] = make_rescore(smat)
    if peq is None:
        peq = build_peq(queries, qlens.astype(np.int64), W, smat)
    out = fn(jnp.asarray(peq), jnp.asarray(qlens.astype(np.int32)),
             jnp.asarray(tiles), jnp.asarray(max_ed.astype(np.int32)), W)
    # Identity computed on the host with the shipped binary's rounding
    # (burst.c:844-860 semantics under -Ofast).
    return rescore_finalize(out, qlens)
