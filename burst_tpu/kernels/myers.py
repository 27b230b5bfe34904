"""Phase-A scan kernel: bit-parallel glocal edit distance (Myers/Hyyro).

This is the accelerator replacement for the reference's hot "aded"
scanner (/root/reference/burst.c:1003-1204). The reference computes the
DP with 8-bit SIMD lanes over 16 references and adaptive banding; here
the Myers bit-vector algorithm runs in "infix" (HW) mode: each 32-bit
word encodes 32 DP rows, so one integer op advances 32 cells per pair.
The batch dimension is (query, reference-tile) pairs; the sequential scan
runs over reference columns. These are the plain XLA versions;
`myers_triton` is the GPU kernel for the pair scan.

Semantics: unit-cost glocal edit distance -- query consumed end-to-end,
reference start/end free -- identical to `refdp.edit_distance_glocal`
for every value <= the caller's error budget (pads and saturation only
affect dead cells; see design notes in kernels/refdp.py).

Variable query lengths are handled by padding queries *at the tail* with
wildcard rows (rows that match every reference code, including the pad
code 0). Provided the reference tile carries >= (32*W - m) trailing pad
columns, the padded-query ED equals the true ED (diagonal zero-cost chains
carry the row-m optimum to row 32*W).

The entry point is `myers_min_ed`, jit-compiled; `build_peq` prepares the
per-query bit tables on the host.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import score_matrix

WORD = 32
TOP = np.uint32(1 << 31)


def words_for(qlen: int) -> int:
    return max(1, -(-qlen // WORD))


def build_peq(queries: np.ndarray, qlens: np.ndarray, W: int,
              smat: np.ndarray | None = None) -> np.ndarray:
    """Peq bit tables for a bucket of queries.

    queries: [B, >=W*32] uint8 code array (tail values ignored past qlens)
    qlens:   [B] true lengths (all <= W*32)
    Returns [B, 16, W] uint32: bit y of word w set iff DP row (w*32+y) is a
    zero-cost match against reference code c. Rows >= qlen are wildcards
    (set for every c, including pad code 0).
    """
    if smat is None:
        smat = score_matrix()
    B = queries.shape[0]
    m_pad = W * WORD
    if B and queries.shape[1] >= int(qlens.max()):
        from ..native import build_peq16_native
        out = build_peq16_native(queries, qlens, W, smat)
        if out is not None:
            return out
    q = np.zeros((B, m_pad), dtype=np.uint8)
    q[:, : queries.shape[1]] = queries[:, :m_pad]
    rows = np.arange(m_pad)[None, :]
    is_pad_row = rows >= qlens[:, None]                      # [B, m_pad]
    # match[b, y, c] = (cost(q[y], c) == 0) or pad row
    match = (smat[q] == 0) | is_pad_row[:, :, None]          # [B, m_pad, 16]
    bits = (np.uint32(1) << (np.arange(m_pad, dtype=np.uint32) % WORD))
    words = rows // WORD                                     # [1, m_pad]
    peq = np.zeros((B, 16, W), dtype=np.uint32)
    for w in range(W):
        sel = (words[0] == w)
        chunk = match[:, sel, :]                             # [B, 32, 16]
        vals = (chunk.astype(np.uint32) * bits[sel][None, :, None]).sum(axis=1)
        peq[:, :, w] = vals                                   # [B, 16]
    return peq


def _select_peq(peq_t: jnp.ndarray, col: jnp.ndarray) -> jnp.ndarray:
    """Select Peq rows by reference letter via a binary select tree.

    peq_t: [C, W, B] uint32 (C a power of two; 16 for nucleotides, up
    to 256 for Xalpha), col: [B] int32 codes.
    Returns [W, B] uint32. C-1 vector selects -- no gathers.
    """
    v = peq_t
    levels = int(np.log2(peq_t.shape[0]))
    for k in range(levels):
        bit = ((col >> k) & 1).astype(bool)                  # [B]
        v = jnp.where(bit[None, None, :], v[1::2], v[0::2])
    return v[0]                                              # [W, B]


def build_peq_x(queries: np.ndarray, qlens: np.ndarray, W: int,
                ncodes: int = 256) -> np.ndarray:
    """Peq tables for Xalpha (raw byte equality, burst.c aded_xalpha):
    zero-cost match iff bytes equal; pad code 0 matches nothing real
    (queries never contain NUL). Rows >= qlen are wildcards."""
    B = queries.shape[0]
    m_pad = W * WORD
    q = np.zeros((B, m_pad), dtype=np.uint8)
    q[:, : queries.shape[1]] = queries[:, :m_pad]
    rows = np.arange(m_pad)[None, :]
    is_pad_row = rows >= qlens[:, None]
    codes = np.arange(ncodes, dtype=np.uint8)
    match = (q[:, :, None] == codes[None, None, :]) | \
        is_pad_row[:, :, None]                     # [B, m_pad, C]
    bits = (np.uint32(1) << (np.arange(m_pad, dtype=np.uint32) % WORD))
    words = rows // WORD
    peq = np.zeros((B, ncodes, W), dtype=np.uint32)
    for w in range(W):
        sel = (words[0] == w)
        chunk = match[:, sel, :]
        peq[:, :, w] = (chunk.astype(np.uint32)
                        * bits[sel][None, :, None]).sum(axis=1)
    return peq


@functools.partial(jax.jit, static_argnames=("W",))
def myers_min_ed(peq: jnp.ndarray, tiles: jnp.ndarray, W: int) -> jnp.ndarray:
    """Minimum glocal ED for each (query, tile) pair.

    peq:   [B, 16, W] uint32 (from build_peq)
    tiles: [B, Lp] uint8 reference codes; Lp must include >= 32*W - min(qlen)
           trailing pad columns (code 0) beyond every tile's true end.
    Returns [B] int32 min edit distance (of the padded query == true query).
    """
    B = peq.shape[0]
    peq_t = jnp.transpose(peq, (1, 2, 0))                    # [16, W, B]
    cols = tiles.T.astype(jnp.int32)                         # [Lp, B]

    ones = jnp.full((W, B), 0xFFFFFFFF, dtype=jnp.uint32)
    zero = jnp.zeros((W, B), dtype=jnp.uint32)
    m_pad = jnp.int32(W * WORD)
    init = (ones, zero, jnp.full((B,), W * WORD, jnp.int32),
            jnp.full((B,), W * WORD, jnp.int32))

    one = jnp.uint32(1)

    def step(state, col):
        VP, VN, score, best = state
        Eq = _select_peq(peq_t, col)                         # [W, B]
        # Xh = (((Eq & VP) + VP) ^ VP) | Eq, with carry across words
        Xv = Eq | VN
        sums = []
        carry = jnp.zeros((B,), jnp.uint32)
        for w in range(W):
            a = Eq[w] & VP[w]
            s1 = a + VP[w]
            c1 = (s1 < a).astype(jnp.uint32)
            s2 = s1 + carry
            c2 = (s2 < s1).astype(jnp.uint32)
            sums.append(s2)
            carry = c1 | c2
        sums = jnp.stack(sums)
        Xh = (sums ^ VP) | Eq
        Ph = VN | ~(Xh | VP)
        Mh = VP & Xh
        # score delta from top row (bit 31 of last word)
        score = score + (Ph[W - 1] >> 31).astype(jnp.int32) \
                      - (Mh[W - 1] >> 31).astype(jnp.int32)
        best = jnp.minimum(best, score)
        # shift Ph/Mh left by one row; infix mode shifts in 0 (row 0 free)
        ph_list, mh_list = [], []
        pc = jnp.zeros((B,), jnp.uint32)
        mc = jnp.zeros((B,), jnp.uint32)
        for w in range(W):
            ph_list.append((Ph[w] << one) | pc)
            mh_list.append((Mh[w] << one) | mc)
            pc = Ph[w] >> 31
            mc = Mh[w] >> 31
        Phs = jnp.stack(ph_list)
        Mhs = jnp.stack(mh_list)
        VP = Mhs | ~(Xv | Phs)
        VN = Phs & Xv
        return (VP, VN, score, best), None

    (_, _, _, best), _ = jax.lax.scan(step, init, cols)
    return best


@functools.partial(jax.jit, static_argnames=("W",))
def myers_min_ed_cross(peq: jnp.ndarray, tiles: jnp.ndarray, W: int
                       ) -> jnp.ndarray:
    """Minimum glocal ED for every (query, tile) combination.

    peq:   [Q, 16, W] uint32
    tiles: [T, Lp] uint8 (trailing pads as in myers_min_ed)
    Returns [Q, T] int32. This is the full-database scan path -- the
    analog of the reference's clump sweep (burst.c:4343-4484): the
    batch grid is (query x tile) and the scan walks tile columns.
    """
    Q = peq.shape[0]
    T = tiles.shape[0]
    peq_t = jnp.transpose(peq, (1, 2, 0))[:, :, :, None]     # [16, W, Q, 1]
    cols = tiles.T.astype(jnp.int32)                         # [Lp, T]

    ones = jnp.full((W, Q, T), 0xFFFFFFFF, dtype=jnp.uint32)
    zero = jnp.zeros((W, Q, T), dtype=jnp.uint32)
    init = (ones, zero, jnp.full((Q, T), W * WORD, jnp.int32),
            jnp.full((Q, T), W * WORD, jnp.int32))
    one = jnp.uint32(1)

    levels = int(np.log2(peq.shape[1]))

    def step(state, col):
        VP, VN, score, best = state
        v = peq_t                                            # [C, W, Q, 1]
        for k in range(levels):
            bit = ((col >> k) & 1).astype(bool)              # [T]
            v = jnp.where(bit[None, None, None, :], v[1::2], v[0::2])
        Eq = v[0]                                            # [W, Q, T]
        Xv = Eq | VN
        sums = []
        carry = jnp.zeros((Q, T), jnp.uint32)
        for w in range(W):
            a = Eq[w] & VP[w]
            s1 = a + VP[w]
            c1 = (s1 < a).astype(jnp.uint32)
            s2 = s1 + carry
            c2 = (s2 < s1).astype(jnp.uint32)
            sums.append(s2)
            carry = c1 | c2
        sums = jnp.stack(sums)
        Xh = (sums ^ VP) | Eq
        Ph = VN | ~(Xh | VP)
        Mh = VP & Xh
        score = score + (Ph[W - 1] >> 31).astype(jnp.int32) \
                      - (Mh[W - 1] >> 31).astype(jnp.int32)
        best = jnp.minimum(best, score)
        ph_list, mh_list = [], []
        pc = jnp.zeros((Q, T), jnp.uint32)
        mc = jnp.zeros((Q, T), jnp.uint32)
        for w in range(W):
            ph_list.append((Ph[w] << one) | pc)
            mh_list.append((Mh[w] << one) | mc)
            pc = Ph[w] >> 31
            mc = Mh[w] >> 31
        Phs = jnp.stack(ph_list)
        Mhs = jnp.stack(mh_list)
        VP = Mhs | ~(Xv | Phs)
        VN = Phs & Xv
        return (VP, VN, score, best), None

    (_, _, _, best), _ = jax.lax.scan(step, init, cols)
    return best


@functools.partial(jax.jit, static_argnames=("W",))
def myers_min_ed_gather(peq_all: jnp.ndarray, tiles_all: jnp.ndarray,
                        pidx: jnp.ndarray, tidx: jnp.ndarray, W: int
                        ) -> jnp.ndarray:
    """Paired scan with device-side gathers.

    peq_all [NQ,16,W] and tiles_all [NT,Lp] live on the device across
    chunk calls; each call ships only the [B] index vectors (tiles
    repeat heavily across candidate pairs).
    """
    peq = jnp.take(peq_all, pidx, axis=0)
    tiles = jnp.take(tiles_all, tidx, axis=0)
    return myers_min_ed(peq, tiles, W)


_NIBBLE_SHIFTS = np.arange(8, dtype=np.uint32) * 4


def pack_words_np(mat: np.ndarray) -> np.ndarray:
    """[n, L] codes -> [n, ceil(L/8)] u32 words, 8 nibble codes each
    (column j = word j >> 3, bits 4*(j & 7); tail columns pad with 0).
    The DB tile store keeps this layout (the reference's own nibble
    clumps, burst.c:2810-2824): half the device memory and upload of
    one byte per code, and one load feeds 8 scan columns."""
    n, L = mat.shape
    full = np.zeros((n, -(-L // 8) * 8), np.uint8)
    full[:, :L] = mat
    pairs = np.ascontiguousarray(full[:, 0::2] | (full[:, 1::2] << 4))
    return pairs.view("<u4").astype(np.uint32, copy=False)


def pack_words(codes: jnp.ndarray) -> jnp.ndarray:
    """In-jit pack_words_np."""
    n, L = codes.shape
    Lw = -(-L // 8)
    full = jnp.pad(codes.astype(jnp.uint32), ((0, 0), (0, Lw * 8 - L)))
    return jnp.bitwise_or.reduce(
        full.reshape(n, Lw, 8) << jnp.asarray(_NIBBLE_SHIFTS), axis=2)


def unpack_words(words: jnp.ndarray, Lp: int) -> jnp.ndarray:
    """[n, Lw] packed words -> [n, Lp] u8 codes (inverse of pack_words)."""
    codes = (words[:, :, None] >> jnp.asarray(_NIBBLE_SHIFTS)) & \
        jnp.uint32(0xF)
    return codes.reshape(words.shape[0], -1)[:, :Lp].astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("W", "Lp"))
def myers_min_ed_gather_pos_packed(peq_all, words, pidx, tidx, W: int,
                                   Lp: int):
    """myers_min_ed_gather_pos over the packed-word tile store (logical
    width Lp)."""
    peq = jnp.take(peq_all, pidx, axis=0)
    tiles = unpack_words(jnp.take(words, tidx, axis=0), Lp)
    return _pos_scan(peq, tiles, W)


@functools.partial(jax.jit, static_argnames=("W",))
def myers_min_ed_gather_pos(peq_all: jnp.ndarray, tiles_all: jnp.ndarray,
                            pidx: jnp.ndarray, tidx: jnp.ndarray, W: int):
    """Myers scan returning a packed [3, B] int32 array of (min ED,
    FIRST best column, LAST best column), columns 1-based in padded
    coordinates. One output buffer = one device->host fetch. For
    zero-ED winners `last` equals
    the rescore kernel's final_pos + the (32W - qlen) pad shift, letting
    phase B be skipped entirely; (first, last) bound the tie span for
    the windowed rescore."""
    peq = jnp.take(peq_all, pidx, axis=0)
    tiles = jnp.take(tiles_all, tidx, axis=0)
    return _pos_scan(peq, tiles, W)


def _pos_scan(peq, tiles, W: int):
    B = peq.shape[0]
    peq_t = jnp.transpose(peq, (1, 2, 0))
    cols = tiles.T.astype(jnp.int32)

    ones = jnp.full((W, B), 0xFFFFFFFF, dtype=jnp.uint32)
    zero = jnp.zeros((W, B), dtype=jnp.uint32)
    init = (ones, zero, jnp.full((B,), W * WORD, jnp.int32),
            jnp.full((B,), W * WORD, jnp.int32),
            jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
            jnp.int32(0))
    one = jnp.uint32(1)

    def step(state, col):
        VP, VN, score, best, first, last, j = state
        Eq = _select_peq(peq_t, col)
        Xv = Eq | VN
        sums = []
        carry = jnp.zeros((B,), jnp.uint32)
        for w in range(W):
            a = Eq[w] & VP[w]
            s1 = a + VP[w]
            c1 = (s1 < a).astype(jnp.uint32)
            s2 = s1 + carry
            c2 = (s2 < s1).astype(jnp.uint32)
            sums.append(s2)
            carry = c1 | c2
        sums = jnp.stack(sums)
        Xh = (sums ^ VP) | Eq
        Ph = VN | ~(Xh | VP)
        Mh = VP & Xh
        score = score + (Ph[W - 1] >> 31).astype(jnp.int32) \
                      - (Mh[W - 1] >> 31).astype(jnp.int32)
        j = j + 1
        strict = score < best
        upd = score <= best
        best = jnp.where(upd, score, best)
        first = jnp.where(strict, j, first)
        last = jnp.where(upd, j, last)
        ph_list, mh_list = [], []
        pc = jnp.zeros((B,), jnp.uint32)
        mc = jnp.zeros((B,), jnp.uint32)
        for w in range(W):
            ph_list.append((Ph[w] << one) | pc)
            mh_list.append((Mh[w] << one) | mc)
            pc = Ph[w] >> 31
            mc = Mh[w] >> 31
        Phs = jnp.stack(ph_list)
        Mhs = jnp.stack(mh_list)
        VP = Mhs | ~(Xv | Phs)
        VN = Phs & Xv
        return (VP, VN, score, best, first, last, j), None

    (_, _, _, best, first, last, _), _ = jax.lax.scan(step, init, cols)
    return jnp.stack([best, first, last])


def min_ed_numpy_reference(q: np.ndarray, r: np.ndarray, W: int | None = None,
                           smat: np.ndarray | None = None) -> int:
    """Convenience single-pair wrapper (host) used in tests."""
    if W is None:
        W = words_for(len(q))
    peq = build_peq(q[None, :], np.array([len(q)]), W, smat)
    qpad = W * WORD - len(q)
    # Bucket the tile length to a multiple of 64 to limit jit recompiles;
    # extra trailing pad columns cannot change the minimum (dead paths only).
    Lp = -(-(len(r) + qpad) // 64) * 64
    tile = np.zeros((1, Lp), dtype=np.uint8)
    tile[0, : len(r)] = r
    out = myers_min_ed(jnp.asarray(peq), jnp.asarray(tile), W)
    return int(np.asarray(out)[0])
