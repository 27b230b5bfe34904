#!/usr/bin/env python3
"""Bring-up check: the served alignment path on one NVIDIA GPU.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the --shards 4 CLI path only

One process, through the entry points a user calls (serving.Aligner,
engine, the CLI's main()). Every phase must pass, or the script exits
non-zero:

1. device  -- JAX's first device is a GPU (no CPU fallback, no
   interpret mode). Prints the device, the card's name and power limit
   (nvidia-smi), the JAX version, XLA_FLAGS, the compile-cache
   directory and the native host library loaded.
2. kernels -- each device kernel of the served path as compiled for
   the card, at real widths, against the plain references with exact
   equality (all u32/i32 integer math, no matrix product, so the
   tolerance is 0): the phase-A pair kernel that engine dispatches
   (W=4 and the gate's widest W, odd and even logical widths, at the
   fused chain's pair count) against kernels.host and refdp; the
   phase-B rescore (full width and windowed) against kernels.host and
   refdp. Times the phase-A kernel against XLA's scan.
3. scour   -- the device scour's candidate sets against the native
   scour's, on the shotgun database.
4. e2e     -- the shotgun workload (bench.make_workload: 1024 families
   x 10 members x 25 kbp, k=12, 100 bp reads at 98% identity, both
   strands, BEST) through Aligner.warmup and align_stream; the fused
   device chain must serve the clear rows, and the b6 bytes must equal
   the all-host path's (BURST_TPU_HOST=1).

--four-cards builds a seeded database with the CLI (the shotgun shape
at a quarter of its families), aligns the reads with `--shards 4
--qshards 1` on four cards and with one card, prints where each tile
shard lives, and compares the bytes.

The last stdout line is {"ok": true, "device": {"platform", "kind",
"count"}}. Every phase is a function with size arguments, so the CPU
tests rehearse them at a tiny size.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

CARD = "card not queried"       # "name, power limit" from nvidia-smi


class SmokeFailure(AssertionError):
    """A phase's result disagreed with its reference."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_info() -> list[str]:
    """nvidia-smi's name and power limit, one line per card (queried
    from a child process that does not import JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable: {e}"]
    lines = r.stdout.strip().splitlines()
    return lines if r.returncode == 0 and lines else \
        [f"nvidia-smi rc={r.returncode}: {r.stderr.strip()}"]


def phase_device(require_gpu: bool = True) -> dict:
    import jax

    from burst_tpu import enable_compile_cache, native

    global CARD
    devs = jax.devices()
    dev = devs[0]
    if require_gpu and dev.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is "
                           f"{dev.platform} ({dev.device_kind})")
    cache = enable_compile_cache()
    if native.load_host() is None:
        raise SmokeFailure("native host library unavailable: "
                           f"{native.host_build_error()}")
    cards = card_info()
    CARD = cards[0]
    log(f"[device] platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    for line in cards:
        log(f"[device] nvidia-smi: {line}")
    log(f"[device] jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache}")
    log(f"[device] native host library {native.host_library_path()}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


def _timed(fn, reps: int) -> float:
    """Seconds per call, warm: one call to compile, then `reps` calls
    ending in block_until_ready."""
    fn().block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    out.block_until_ready()
    return (time.perf_counter() - t0) / reps


def _random_tiles(rng, n_tiles: int, real_len: int, width: int):
    """[n_tiles, width] tile rows: DNA codes with a few IUPAC codes,
    then pad code 0."""
    tiles = np.zeros((n_tiles, width), np.uint8)
    body = rng.integers(1, 5, size=(n_tiles, real_len)).astype(np.uint8)
    amb = rng.random((n_tiles, real_len)) < 0.002
    body[amb] = rng.integers(5, 16, size=int(amb.sum()))
    tiles[:, :real_len] = body
    return tiles


def _planted_queries(rng, tiles, real_len: int, n: int, qlen: int,
                     max_edits: int):
    """n queries of length qlen: each copies a window of a random tile
    and takes up to max_edits substitutions/indels. Returns (codes
    [n, qlen], source tile per query)."""
    src = rng.integers(0, tiles.shape[0], n)
    q = np.zeros((n, qlen), np.uint8)
    for i in range(n):
        st = int(rng.integers(0, real_len - qlen - max_edits))
        s = list(tiles[src[i], st: st + qlen + max_edits])
        for _ in range(int(rng.integers(0, max_edits + 1))):
            p = int(rng.integers(0, qlen))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                s[p] = int(rng.integers(1, 5))
            elif kind == 1:
                del s[p]
            else:
                s.insert(p, int(rng.integers(1, 5)))
        q[i] = s[:qlen]
    return q, src


def _pair_case(rng, W: int, qlen: int, width: int, n_tiles: int,
               n_queries: int, n_pairs: int, own_frac: float):
    """One phase-A/B test case: tiles, queries, Peq and pairs, a
    fraction `own_frac` of them a query against its own source tile
    (`own` marks those)."""
    from burst_tpu.alphabet import score_matrix
    from burst_tpu.kernels import myers

    real_len = width - 32 * W
    tiles = _random_tiles(rng, n_tiles, real_len, width)
    q, src = _planted_queries(rng, tiles, real_len, n_queries, qlen,
                              max(2, qlen // 25))
    qlens = np.full(n_queries, qlen, np.int64)
    peq = myers.build_peq(q, qlens, W, score_matrix())
    pidx = rng.integers(0, n_queries, n_pairs).astype(np.int32)
    own = rng.random(n_pairs) < own_frac
    tidx = np.where(own, src[pidx],
                    rng.integers(0, n_tiles, n_pairs)).astype(np.int32)
    return tiles, q, qlens, peq, pidx, tidx, real_len, own


PAIR_CASES = ((4, 100, 417), (4, 100, 416), (8, 256, 545), (8, 256, 544))


def phase_kernels(n_pairs: int | None = None, n_tiles: int = 65536,
                  n_queries: int = 4096, widths=PAIR_CASES,
                  n_oracle: int = 16, seed: int = 1,
                  time_reps: int = 0) -> dict:
    """Phase-A pair kernel as engine dispatches it, exact against the
    host kernel on every pair and refdp on a sample. `widths` lists
    (W, query length, logical tile width): 100 bp reads (W=4) and the
    gate's widest W, each at an odd and an even width. n_pairs defaults
    to the fused chain's launch (2 * CHUNK_ROWS). With time_reps, times
    the Triton kernel against XLA's scan per call."""
    import jax.numpy as jnp

    from burst_tpu import engine
    from burst_tpu.alphabet import score_matrix
    from burst_tpu.kernels import myers, refdp, scour_device
    from burst_tpu.kernels.host import myers_pairs_host
    from burst_tpu.kernels.myers_triton import MAX_W, myers_pairs_triton

    if n_pairs is None:
        n_pairs = 2 * scour_device.CHUNK_ROWS
    rng = np.random.default_rng(seed)
    smat = score_matrix()
    timings = {}
    log(f"[kernels] gate: the Triton pair kernel takes W <= {MAX_W}")
    for W, qlen, width in widths:
        tiles, q, qlens, peq, pidx, tidx, real_len, own = _pair_case(
            rng, W, qlen, width, n_tiles, n_queries, n_pairs, 0.5)
        words_d = jnp.asarray(myers.pack_words_np(tiles))
        peq_d = jnp.asarray(peq)
        kernel = "triton" if engine._use_triton(W, peq_d) else "xla"
        got = np.asarray(engine._myers_pairs_dispatch_packed(
            peq_d, words_d, width, jnp.asarray(pidx), jnp.asarray(tidx),
            W))
        ref = myers_pairs_host(peq, tiles, pidx, tidx, W)
        check(np.array_equal(got, ref),
              f"phase A ({kernel}) W={W} Lp={width} differs from host "
              f"on {int((got != ref).any(axis=0).sum())} pairs")
        # refdp is exact for values within a query's error budget;
        # past it both sides only need to exceed the budget
        cap = max(4, qlen // 10)
        sample = np.concatenate([np.nonzero(own)[0][:n_oracle // 2],
                                 np.nonzero(~own)[0][:n_oracle // 2]])
        for i in sample:
            r = tiles[tidx[i], :real_len]
            want = refdp.edit_distance_glocal(q[pidx[i]], r, smat)
            check(min(int(got[0, i]), cap + 1) == min(want, cap + 1),
                  f"phase A W={W} pair {i}: ed {got[0, i]} vs refdp "
                  f"{want}")
        # arbitrary u32 Peq words drive every carry path of the adder
        hp = rng.integers(0, 2**32, size=peq.shape, dtype=np.uint64
                          ).astype(np.uint32)
        goth = np.asarray(engine._myers_pairs_dispatch_packed(
            jnp.asarray(hp), words_d, width, jnp.asarray(pidx),
            jnp.asarray(tidx), W))
        check(np.array_equal(goth, myers_pairs_host(hp, tiles, pidx,
                                                    tidx, W)),
              f"phase A ({kernel}) W={W} differs from host on high-bit "
              f"Peq words")
        log(f"[kernels] phase A {kernel} W={W} Lp={width} "
            f"pairs={n_pairs}: exact vs host on all pairs, vs refdp on "
            f"{len(sample)}, high-bit Peq exact")
        if time_reps and kernel == "triton" and W == 4 and \
                width % 2 == 0:
            for B in (n_pairs, 4 * n_pairs):
                pi = jnp.asarray(np.resize(pidx, B))
                ti = jnp.asarray(np.resize(tidx, B))
                def tri():
                    return myers_pairs_triton(peq_d, words_d, pi, ti,
                                              W=W, Lp=width)

                def xla():
                    return myers.myers_min_ed_gather_pos_packed(
                        peq_d, words_d, pi, ti, W, width)

                t_tri, t_xla = _timed(tri, time_reps), \
                    _timed(xla, time_reps)
                check(np.array_equal(np.asarray(tri()), np.asarray(xla())),
                      "Triton and XLA phase A differ")
                timings[f"phaseA_W{W}_B{B}"] = (t_tri, t_xla)
                log(f"[kernels] phase A per call W={W} Lp={width} "
                    f"pairs={B}: triton {t_tri * 1e3:.4f} ms, XLA scan "
                    f"{t_xla * 1e3:.4f} ms ({CARD})")
    return timings


def phase_rescore(n_pairs: int | None = None, n_tiles: int = 16384,
                  n_queries: int = 4096, widths=((4, 100), (8, 256)),
                  n_oracle: int = 12, seed: int = 2,
                  time_reps: int = 0) -> dict:
    """Phase-B rescore (XLA) on winner-like pairs, full width and
    windowed exactly as engine.rescore_winners windows them, against
    kernels.host on every pair and refdp on a sample."""
    from burst_tpu.alphabet import score_matrix
    from burst_tpu.engine import QCHUNK
    from burst_tpu.kernels import refdp
    from burst_tpu.kernels.host import myers_pairs_host, rescore_pairs_host
    from burst_tpu.kernels.rescore import rescore_pairs_gather_async

    import jax.numpy as jnp

    if n_pairs is None:
        n_pairs = 4 * QCHUNK            # engine's rescore chunk
    rng = np.random.default_rng(seed)
    smat = score_matrix()
    timings = {}
    for W, qlen in widths:
        m_pad = 32 * W
        width = -(-(384 + m_pad) // 64) * 64    # a 320-shear bucket
        # winners: each query against its own source tile
        tiles, q, qlens, peq, pidx, tidx, real_len, _ = _pair_case(
            rng, W, qlen, width, n_tiles, n_queries, n_pairs, 1.0)
        ea = myers_pairs_host(peq, tiles, pidx, tidx, W)
        bound = ea[0].astype(np.int64)
        first, last = ea[1].astype(np.int64), ea[2].astype(np.int64)
        rows = min(m_pad, -(-qlen // 8) * 8)
        Lw = -(-(rows + int(bound.max()) + 2) // 128) * 128
        x0 = np.maximum(first - m_pad - bound - 1, 0)
        fits = (last - first) <= Lw - 1 - rows - bound - 1
        peq_d, tiles_d = jnp.asarray(peq), jnp.asarray(tiles)
        for windowed in (False, True):
            sel = np.nonzero(fits)[0] if windowed else np.arange(n_pairs)
            check(len(sel) > 0, f"W={W}: no pair fits the window")
            sel = np.resize(sel, n_pairs)
            args = (peq_d, tiles_d, pidx[sel], tidx[sel],
                    qlens[pidx[sel]], bound[sel], W, smat)
            kw = dict(x0=x0[sel], Lw=Lw) if windowed else {}
            got = np.asarray(rescore_pairs_gather_async(*args, **kw))
            ref = rescore_pairs_host(
                peq, tiles, pidx[sel], tidx[sel], qlens[pidx[sel]],
                bound[sel], W, rows, x0[sel] if windowed else None,
                Lw if windowed else None)
            tag = f"W={W} " + (f"window Lw={Lw}" if windowed
                               else f"full Lp={width}")
            check(np.array_equal(got, ref),
                  f"phase B {tag} differs from host on "
                  f"{int((got != ref).any(axis=0).sum())} pairs")
            for i in range(min(n_oracle, len(sel))):
                j = sel[i]
                want = refdp.rescore(q[pidx[j]],
                                     tiles[tidx[j], :real_len],
                                     int(bound[j]), smat)
                fp = int(got[3, i]) + (int(x0[j]) if windowed else 0)
                check((int(got[0, i]), int(got[1, i]), int(got[2, i]), fp)
                      == (want["ed"], want["gap_q"], want["gap_r"],
                          want["final_pos"]),
                      f"phase B {tag} pair {j} differs from refdp")
            log(f"[kernels] phase B XLA {tag} pairs={len(sel)}: exact "
                f"vs host on all pairs, vs refdp on "
                f"{min(n_oracle, len(sel))}")
            if time_reps:
                t = _timed(
                    lambda: rescore_pairs_gather_async(*args, **kw),
                    time_reps)
                timings[f"phaseB_W{W}_{'win' if windowed else 'full'}"] = t
                log(f"[kernels] phase B per call {tag} pairs={len(sel)}: "
                    f"XLA {t * 1e3:.4f} ms ({CARD})")
    return timings


def _visits_equal(a, b) -> bool:
    same = [np.array_equal(a.offs, b.offs), np.array_equal(a.flat, b.flat),
            np.array_equal(a.full, b.full),
            np.array_equal(np.asarray(a.bflat), np.asarray(b.bflat)),
            np.array_equal(a.boffs, b.boffs),
            (a.pass_keys is None) == (b.pass_keys is None)]
    if a.pass_keys is not None and b.pass_keys is not None:
        same.append(np.array_equal(a.pass_keys, b.pass_keys))
    return all(same)


def phase_scour(rd, acc, qheads, reads, thres: float) -> None:
    """Device scour (QBUNCH=1 rows and QBUNCH=16 bunches) against the
    native scour's candidate sets."""
    from burst_tpu import engine
    from burst_tpu.process import bin_queries_for_accel, process_queries

    for qbunch in (1, 16):
        qd = process_queries(list(qheads), [r.copy() for r in reads],
                             thres, True)
        qbins = bin_queries_for_accel(qd, acc.k, 1)
        dev = engine.accel_candidates(qd, rd, acc, qbins, qbunch=qbunch,
                                      dev_scour=True)
        host = engine.accel_candidates(qd, rd, acc, qbins, qbunch=qbunch,
                                       dev_scour=False)
        check(host.offs[-1] > 0, "scour found no candidates")
        check(_visits_equal(dev, host),
              f"device scour (QBUNCH={qbunch}) differs from native")
        log(f"[scour] QBUNCH={qbunch} rows={len(qd.seqs)}: device "
            f"candidate lists and unit keys equal native "
            f"({int(host.offs[-1])} visits)")


def build_db(rheads, refs):
    """Database + accelerator + unit index (host set-up)."""
    import bench
    from burst_tpu import engine

    rd, acc = bench.build_shotgun_db(rheads, refs)
    engine.rd_acc_unit_index(rd, acc)
    return rd, acc


def phase_e2e(rd, acc, qheads, reads, thres: float, batch: int = 2048,
              read_len: int = 100) -> dict:
    """Aligner.warmup + align_stream on the device, then the same
    batches on the all-host path: identical, non-empty b6 bytes, and
    the fused chain served every batch."""
    import jax

    from burst_tpu import devtime, engine
    from burst_tpu.kernels import scour_device
    from burst_tpu.serving import Aligner

    al = Aligner(rd, acc, thres=thres, mode="BEST", do_rc=True)
    t0 = time.perf_counter()
    jax.block_until_ready((scour_device.get_tables(acc).ids,
                           engine._tiles_device_all(rd)[0]))
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    al.warmup(read_len=read_len, n=batch)
    warm_s = time.perf_counter() - t0
    batches = [(list(qheads[i:i + batch]), reads[i:i + batch])
               for i in range(0, len(reads), batch)]

    def copies():
        return [(h, [r.copy() for r in s]) for h, s in batches]

    before = dict(engine.fused_served)
    t0 = time.perf_counter()
    first = list(al.align_stream(copies()))
    first_s = time.perf_counter() - t0
    phase_b = {"s": 0.0}
    plain = engine.rescore_winners

    def timed_rescore(*a, **k):
        t = time.perf_counter()
        try:
            return plain(*a, **k)
        finally:
            phase_b["s"] += time.perf_counter() - t

    engine.rescore_winners = timed_rescore
    try:
        t0 = time.perf_counter()
        with devtime.track() as blocked:
            out = list(al.align_stream(copies()))
        dt = time.perf_counter() - t0
    finally:
        engine.rescore_winners = plain
    served_b = engine.fused_served["batches"] - before["batches"]
    served_r = engine.fused_served["rows"] - before["rows"]
    check(out == first, "device passes differ from each other")
    check(served_b == 2 * len(batches) and served_r > 0,
          f"fused device chain served {served_b} of {2 * len(batches)} "
          f"batches ({served_r} rows)")
    os.environ["BURST_TPU_HOST"] = "1"
    try:
        t0 = time.perf_counter()
        host = [al.align_batch(h, s) for h, s in copies()]
        host_s = time.perf_counter() - t0
    finally:
        del os.environ["BURST_TPU_HOST"]
    dev_b6, host_b6 = b"".join(out), b"".join(host)
    check(len(dev_b6) > 0 and dev_b6 == host_b6,
          f"device b6 ({len(dev_b6)} bytes) differs from all-host b6 "
          f"({len(host_b6)} bytes)")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    rps = len(reads) / dt
    log(f"[e2e] {len(reads)} reads in {len(batches)} batches: b6 "
        f"identical to the all-host path ({dev_b6.count(b'\n')} rows, "
        f"{len(dev_b6)} bytes); fused chain served {served_b} batches, "
        f"{served_r} clear rows")
    log(f"[e2e] set-up: upload {upload_s:.3f} s, warmup (compile) "
        f"{warm_s:.3f} s, first pass {first_s:.3f} s ({CARD})")
    log(f"[e2e] device pass {dt:.4f} s = {rps:.1f} reads/s; blocked on "
        f"fetches {blocked['s']:.4f} s over {blocked['n']}; phase-B "
        f"stage {phase_b['s']:.4f} s summed over batches; all-host pass "
        f"{host_s:.4f} s ({CARD})")
    log(f"[e2e] peak_bytes_in_use {peak} ({CARD})")
    return {"reads_per_s": rps, "pass_s": dt, "upload_s": upload_s,
            "warmup_s": warm_s, "first_pass_s": first_s,
            "peak_bytes": peak, "phase_b_s": phase_b["s"],
            "host_s": host_s}


# The four-card phase cuts the shotgun DB to a quarter (256 families,
# 64 Mbp; widths and read set unchanged): a four-card call costs four
# times the card time, and the phase checks placement and bytes.
FOUR_CARD_WORKLOAD = {"n_fam": 256}


def phase_four_cards(workdir: str, n_shards: int = 4,
                     workload: dict | None = None) -> None:
    """CLI on a seeded DB: --shards n --qshards 1 against one card."""
    import bench
    from burst_tpu import cli
    from burst_tpu.parallel import mesh

    rheads, refs, qheads, reads = bench.make_workload(**(workload or {}))
    os.makedirs(workdir, exist_ok=True)
    paths = {k: os.path.join(workdir, k) for k in
             ("refs.fa", "reads.fa", "db.edx", "db.acx", "one.b6",
              "sharded.b6")}
    for name, heads, seqs in (("refs.fa", rheads, refs),
                              ("reads.fa", qheads, reads)):
        with open(paths[name], "wb") as f:
            for h, s in zip(heads, seqs):
                f.write(b">" + h + b"\n" + s.tobytes() + b"\n")
    t0 = time.perf_counter()
    check(cli.main(["burst", "-r", paths["refs.fa"], "-o",
                    paths["db.edx"], "-a", paths["db.acx"], "-d",
                    "QUICK", "320", "-s", "320", "--kmer", "12",
                    "--noprogress"]) == 0, "CLI makedb failed")
    log(f"[four-cards] CLI makedb {time.perf_counter() - t0:.3f} s")
    align = ["burst", "-r", paths["db.edx"], "-a", paths["db.acx"], "-q",
             paths["reads.fa"], "-m", "BEST", "-fr", "-i", "0.98",
             "--noprogress"]
    placed = []
    plain = mesh._sharded_tiles

    def recording(*a, **k):
        got = plain(*a, **k)
        placed.append(got[0])
        return got

    mesh._sharded_tiles = recording
    try:
        t0 = time.perf_counter()
        check(cli.main(align + ["-o", paths["one.b6"]]) == 0,
              "one-card CLI run failed")
        t1 = time.perf_counter()
        check(cli.main(align + ["-o", paths["sharded.b6"], "--shards",
                                str(n_shards), "--qshards", "1"]) == 0,
              "sharded CLI run failed")
        t2 = time.perf_counter()
    finally:
        mesh._sharded_tiles = plain
    check(placed, "the sharded run placed no tile shards")
    for arr in placed:
        devs = sorted(str(s.device) for s in arr.addressable_shards)
        log(f"[four-cards] tile shards {arr.shape} device_set="
            f"{sorted(str(d) for d in arr.sharding.device_set)} "
            f"shards on {devs}")
        check(len(arr.sharding.device_set) == n_shards and
              len(set(devs)) == n_shards,
              f"tile shards sit on {len(set(devs))} devices, not "
              f"{n_shards}")
    with open(paths["one.b6"], "rb") as f1, \
            open(paths["sharded.b6"], "rb") as f2:
        one, sharded = f1.read(), f2.read()
    check(len(one) > 0 and one == sharded,
          f"--shards {n_shards} b6 ({len(sharded)} bytes) differs from "
          f"one card ({len(one)} bytes)")
    log(f"[four-cards] {len(reads)} reads: --shards {n_shards} b6 "
        f"identical to one card ({one.count(b'\n')} rows); one card "
        f"{t1 - t0:.3f} s, sharded {t2 - t1:.3f} s (first runs, "
        f"compiles included; {CARD})")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX's first device is "
              f"{dev.platform}", file=sys.stderr)
        return 1
    if four and len(jax.devices()) < 4:
        print(f"chip_smoke --four-cards: JAX sees "
              f"{len(jax.devices())} GPUs", file=sys.stderr)
        return 1
    import bench

    info = phase_device()
    if four:
        phase_four_cards(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), ".smoke", "four_cards"),
            workload=FOUR_CARD_WORKLOAD)
    else:
        phase_kernels(time_reps=20)
        phase_rescore(time_reps=20)
        rheads, refs, qheads, reads = bench.make_workload()
        t0 = time.perf_counter()
        rd, acc = build_db(rheads, refs)
        log(f"[e2e] set-up: DB build {time.perf_counter() - t0:.3f} s "
            f"({sum(len(r) for r in refs) / 1e6:.0f} Mbp, "
            f"{rd.tot_units} units, k={acc.k})")
        phase_scour(rd, acc, qheads[:4096], reads[:4096], bench.THRES)
        phase_e2e(rd, acc, qheads, reads, bench.THRES)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
