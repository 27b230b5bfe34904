"""Phase-A pair kernel for NVIDIA GPUs: Pallas, lowered through Triton.

Same integer semantics as `myers.myers_min_ed_gather_pos` (exact u32/i32
math): for B (query, tile) pairs it returns the packed [3, B] int32
(min ED, first best column, last best column), columns 1-based in
padded coordinates.

XLA lowers the `lax.scan` of `myers._pos_scan` to a loop with at least
one launch per reference column, and every column round-trips the whole
carry (VP/VN, score, best, first, last) through device memory. Here one
pair lives on one thread for the whole sweep: its 16*W Peq planes and
its scan state stay in registers, and the only memory traffic inside
the loop is one u32 word of the pair's own tile row per 8 columns (the
tile store keeps 8 nibble codes per word; `myers.pack_words_np`). Each
program loads its pairs' tile rows by `tidx`, so no gather or transpose
runs ahead of the kernel.

Register budget: the Peq select keeps 16*W u32 planes per thread (64
at W=4, 128 at W=8) next to 2*W state words, against the hardware's
255 registers a thread. `MAX_W` is the gate `engine` applies.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MAX_W = 8        # widest query (32*W rows) whose planes fit registers
BLOCK = 64       # pairs per program, one pair per thread


def _pair_kernel(pidx_ref, tidx_ref, peq_ref, words_ref,
                 ed_ref, first_ref, last_ref, *, W: int, Lp: int):
    p = pidx_ref[...]
    t = tidx_ref[...]
    # planes[w][c]: Peq word w of code c for each lane's query
    planes = [[peq_ref[p, c * W + w] for c in range(16)]
              for w in range(W)]
    nb = p.shape[0]
    one = jnp.uint32(1)

    def column(code, j, state):
        vp, vn, score, best, first, last = state
        bits = [((code >> k) & one) == one for k in range(4)]
        eq = []
        for w in range(W):
            v = planes[w]
            for b in bits:
                v = [jnp.where(b, v[2 * i + 1], v[2 * i])
                     for i in range(len(v) // 2)]
            eq.append(v[0])
        carry = jnp.zeros((nb,), jnp.uint32)
        ph, mh = [], []
        for w in range(W):
            a = eq[w] & vp[w]
            s1 = a + vp[w]
            s2 = s1 + carry
            carry = ((s1 < a) | (s2 < s1)).astype(jnp.uint32)
            xh = (s2 ^ vp[w]) | eq[w]
            ph.append(vn[w] | ~(xh | vp[w]))
            mh.append(vp[w] & xh)
        score = score + (ph[W - 1] >> 31).astype(jnp.int32) \
            - (mh[W - 1] >> 31).astype(jnp.int32)
        valid = j < Lp
        strict = (score < best) & valid
        upd = (score <= best) & valid
        best = jnp.where(upd, score, best)
        first = jnp.where(strict, j + 1, first)
        last = jnp.where(upd, j + 1, last)
        pc = jnp.zeros((nb,), jnp.uint32)
        mc = jnp.zeros((nb,), jnp.uint32)
        nvp, nvn = [], []
        for w in range(W):
            xv = eq[w] | vn[w]
            phs = (ph[w] << one) | pc
            mhs = (mh[w] << one) | mc
            pc = ph[w] >> 31
            mc = mh[w] >> 31
            nvp.append(mhs | ~(xv | phs))
            nvn.append(phs & xv)
        return tuple(nvp), tuple(nvn), score, best, first, last

    def word_step(wj, state):
        word = words_ref[t, wj]
        for sub in range(8):
            code = (word >> jnp.uint32(4 * sub)) & jnp.uint32(15)
            state = column(code, wj * 8 + sub, state)
        return state

    m_pad = jnp.full((nb,), W * 32, jnp.int32)
    zero = jnp.zeros((nb,), jnp.int32)
    init = (tuple(jnp.full((nb,), 0xFFFFFFFF, jnp.uint32)
                  for _ in range(W)),
            tuple(jnp.zeros((nb,), jnp.uint32) for _ in range(W)),
            m_pad, m_pad, zero, zero)
    _, _, _, best, first, last = jax.lax.fori_loop(
        0, words_ref.shape[1], word_step, init)
    ed_ref[...] = best
    first_ref[...] = first
    last_ref[...] = last


@functools.partial(jax.jit, static_argnames=("W", "Lp", "interpret"))
def myers_pairs_triton(peq_all, words, pidx, tidx, W: int, Lp: int,
                       interpret: bool = False):
    """Packed [3, B] (ed, first, last) for the pairs (pidx, tidx).

    peq_all [NQ, 16, W] u32; words [NT, Lpw] u32 tile rows, 8 nibble
    codes per word (column j = word j >> 3, bits 4*(j & 7)); Lp <=
    8*Lpw is the logical width (updates past it are masked). B pads up
    to a multiple of BLOCK. `interpret` runs the kernel on the CPU
    (tests only)."""
    B = pidx.shape[0]
    Bp = -(-B // BLOCK) * BLOCK
    if Bp != B:
        pidx = jnp.pad(pidx, (0, Bp - B))
        tidx = jnp.pad(tidx, (0, Bp - B))
    peq2 = peq_all.reshape(peq_all.shape[0], 16 * W)
    pair = pl.BlockSpec((BLOCK,), lambda g: (g,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda g: (0, 0))  # noqa: E731
    out = jax.ShapeDtypeStruct((Bp,), jnp.int32)
    ed, first, last = pl.pallas_call(
        functools.partial(_pair_kernel, W=W, Lp=Lp),
        grid=(Bp // BLOCK,),
        in_specs=[pair, pair, whole(peq2), whole(words)],
        out_specs=[pair, pair, pair],
        out_shape=[out, out, out],
        compiler_params=plgpu.CompilerParams(
            num_warps=BLOCK // 32, num_stages=1),
        interpret=interpret,
        name="myers_pairs_triton",
    )(pidx.astype(jnp.int32), tidx.astype(jnp.int32), peq2, words)
    return jnp.stack([ed, first, last])[:, :B]


@functools.partial(jax.jit, static_argnames=("W", "interpret"))
def myers_pairs_triton_codes(peq_all, tiles_all, pidx, tidx, W: int,
                             interpret: bool = False):
    """myers_pairs_triton over a [NT, Lp] one-code-per-byte tile store:
    the pairs' rows are gathered and packed on the way in."""
    from .myers import pack_words
    words = pack_words(jnp.take(tiles_all, tidx, axis=0))
    rows = jnp.arange(pidx.shape[0], dtype=jnp.int32)
    return myers_pairs_triton(peq_all, words, pidx, rows, W=W,
                              Lp=tiles_all.shape[1], interpret=interpret)
