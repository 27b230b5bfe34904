"""Phase-A Triton pair kernel: interpret mode against XLA's scan, its
lowering for the GPU, and engine's choice of kernel.

The kernel runs here through the Pallas interpreter (interpret=True is
a test-only argument); the compiled kernel is checked on the card by
chip_smoke.py and by the `gpu`-marked test below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burst_tpu import engine
from burst_tpu.alphabet import score_matrix
from burst_tpu.kernels import myers
from burst_tpu.kernels import myers_triton
from burst_tpu.kernels.host import myers_pairs_host


def _case(seed, W, Lp, B, NQ=24, NT=20, high_bits=True):
    """Random store + pairs. high_bits: arbitrary u32 Peq words, which
    drive every carry path of the multi-word adder (s1 < a unsigned)."""
    rng = np.random.default_rng(seed)
    if high_bits:
        peq = rng.integers(0, 2**32, size=(NQ, 16, W), dtype=np.uint64
                           ).astype(np.uint32)
    else:
        qs = rng.integers(1, 5, size=(NQ, 32 * W)).astype(np.uint8)
        qlens = rng.integers(16, 32 * W + 1, size=NQ).astype(np.int64)
        peq = myers.build_peq(qs, qlens, W, score_matrix())
    tiles = rng.integers(0, 16, size=(NT, Lp)).astype(np.uint8)
    pidx = rng.integers(0, NQ, B).astype(np.int32)
    tidx = rng.integers(0, NT, B).astype(np.int32)
    return peq, tiles, pidx, tidx


@pytest.mark.parametrize("W,Lp,B", [
    (1, 77, 100),     # odd width; 100 pairs pad to two 64-pair blocks
    (1, 64, 64),
    (4, 193, 64),
    (4, 192, 128),
    (8, 133, 64),
    (8, 136, 64),
])
def test_triton_interpret_matches_xla(W, Lp, B):
    peq, tiles, pidx, tidx = _case(W * 1000 + Lp, W, Lp, B)
    words = myers.pack_words_np(tiles)
    args = (jnp.asarray(peq), jnp.asarray(words), jnp.asarray(pidx),
            jnp.asarray(tidx))
    ref = np.asarray(myers.myers_min_ed_gather_pos_packed(*args, W, Lp))
    got = np.asarray(myers_triton.myers_pairs_triton(
        *args, W=W, Lp=Lp, interpret=True))
    assert got.shape == (3, B)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        ref, myers_pairs_host(peq, tiles, pidx, tidx, W))


def test_triton_codes_store_matches_xla():
    """The one-code-per-byte store packs the pairs' rows on the way in."""
    W, Lp, B = 2, 101, 64
    peq, tiles, pidx, tidx = _case(7, W, Lp, B, high_bits=False)
    args = (jnp.asarray(peq), jnp.asarray(tiles), jnp.asarray(pidx),
            jnp.asarray(tidx))
    ref = np.asarray(myers.myers_min_ed_gather_pos(*args, W))
    got = np.asarray(myers_triton.myers_pairs_triton_codes(
        *args, W=W, interpret=True))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("L", [1, 7, 8, 9, 417])
def test_pack_words_roundtrip(L):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 16, size=(5, L)).astype(np.uint8)
    words = myers.pack_words_np(codes)
    assert words.dtype == np.uint32 and words.shape == (5, -(-L // 8))
    np.testing.assert_array_equal(
        np.asarray(myers.pack_words(jnp.asarray(codes))), words)
    np.testing.assert_array_equal(
        np.asarray(myers.unpack_words(jnp.asarray(words), L)), codes)


@pytest.mark.parametrize("W", [4, myers_triton.MAX_W])
def test_triton_lowers_for_gpu(W):
    """Pallas lowers the kernel to Triton IR for CUDA without a card
    (the PTX compile itself happens on the card)."""
    peq, tiles, pidx, tidx = _case(3, W, 416, 8192, NQ=4096, NT=256)
    words = myers.pack_words_np(tiles)
    fn = jax.jit(lambda a, b, c, d: myers_triton.myers_pairs_triton(
        a, b, c, d, W=W, Lp=416))
    text = fn.trace(jnp.asarray(peq), jnp.asarray(words),
                    jnp.asarray(pidx), jnp.asarray(tidx)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text and "myers_pairs_triton" in text


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,W,want", [
    ("gpu", 4, "triton"),
    ("gpu", myers_triton.MAX_W, "triton"),
    ("gpu", myers_triton.MAX_W + 1, "xla"),   # past the register gate
    ("cpu", 4, "xla"),
])
def test_dispatch_choice(monkeypatch, platform, W, want):
    calls = []
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice(platform)])
    monkeypatch.setattr(myers_triton, "myers_pairs_triton",
                        lambda *a, **k: calls.append("triton") or "t")
    monkeypatch.setattr(myers_triton, "myers_pairs_triton_codes",
                        lambda *a, **k: calls.append("triton") or "t")
    monkeypatch.setattr(myers, "myers_min_ed_gather_pos_packed",
                        lambda *a, **k: calls.append("xla") or "x")
    monkeypatch.setattr(myers, "myers_min_ed_gather_pos",
                        lambda *a, **k: calls.append("xla") or "x")
    peq = np.zeros((8, 16, W), np.uint32)
    idx = np.zeros(8, np.int32)
    engine._myers_pairs_dispatch_packed(peq, None, 64, idx, idx, W)
    engine._myers_pairs_dispatch(peq, None, idx, idx, W)
    assert calls == [want, want]


@pytest.mark.gpu
def test_triton_kernel_compiled_on_gpu(gpu_device):
    """The compiled kernel (no interpreter) against the host kernel."""
    W, Lp, B = 4, 416, 8192
    peq, tiles, pidx, tidx = _case(5, W, Lp, B, NQ=4096, NT=4096)
    got = np.asarray(myers_triton.myers_pairs_triton(
        jnp.asarray(peq), jnp.asarray(myers.pack_words_np(tiles)),
        jnp.asarray(pidx), jnp.asarray(tidx), W=W, Lp=Lp))
    np.testing.assert_array_equal(
        got, myers_pairs_host(peq, tiles, pidx, tidx, W))
