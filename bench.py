"""Benchmark workloads, and one device run of the shotgun workload.

`make_workload` mirrors the reference's headline configuration
(/root/reference/README.md:16): 100bp shotgun reads at 98% identity,
both strands, against a sheared reference database with a k-mer
accelerator, BEST mode. Unlike a uniform-random database (whose
pigeonhole filter collapses every read to ~1 candidate), the references
form homologous families -- n_fam ancestors, n_mem members each at ~1%
divergence -- so every read must be aligned against its whole family,
the realistic candidate density of RefSeq/Greengenes-style databases.
At the defaults: 1024 x 10 x 25 kbp = 256 Mbp, 20,000 reads.

`make_amplicon_workload` models the reference's other published figure
(12M 292bp amplicons vs Greengenes 13.8 97%): a 97%-clustered 16S-style
DB (members ~3% pairwise divergence, 139 Mbp) with a taxonomy, 292bp
reads at -i 0.97, CAPITALIST + LCA.

`python bench.py` builds the shotgun database (one-time preprocessing,
excluded from the rate as in the reference's reported reads/s), warms
the served path up and prints one JSON line: reads/s of the warm
device pass through `serving.Aligner`, with the device it ran on. It
exits non-zero when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

READ_LEN = 100
THRES = 0.98
K = 12

A_READ_LEN = 292
A_THRES = 0.97

# family postings run ~10 deep and background 12-mers ~15 deep at the
# shotgun shape; the default 256-slot scour budget would overflow
# every row onto the host re-scour
os.environ.setdefault("BURST_TPU_SCOUR_E", "3072")


def make_workload(n_fam: int = 1024, n_mem: int = 10,
                  fam_len: int = 25000, divergence: float = 0.01,
                  n_reads: int = 20000, seed: int = 20260817):
    """(ref headers, ref seqs, read headers, reads) of the shotgun
    workload; reads carry 0-2 substitutions."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs, rheads = [], []
    n_mut = int(divergence * fam_len)
    for fi in range(n_fam):
        anc = rng.choice(bases, size=fam_len)
        for m in range(n_mem):
            r = anc.copy()
            pos = rng.integers(0, fam_len, n_mut)
            r[pos] = bases[rng.integers(0, 4, n_mut)]
            refs.append(r)
            rheads.append(f"f{fi:05d}m{m:02d}".encode())
    reads, qheads = [], []
    n_refs = len(refs)
    for i in range(n_reads):
        s = refs[int(rng.integers(0, n_refs))]
        st = int(rng.integers(0, len(s) - READ_LEN))
        r = s[st:st + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, READ_LEN))
            r[p] = bases[int(rng.integers(0, 4))]
        reads.append(r)
        qheads.append(f"q{i:06d}".encode())
    return rheads, refs, qheads, reads


def make_amplicon_workload(n_fam: int = 1200, n_mem: int = 80,
                           fam_len: int = 1450, n_reads: int = 20000,
                           seed: int = 20260821):
    """(ref headers, ref seqs, taxonomy strings, read headers, reads) of
    the amplicon workload; reads carry 0-5 substitutions."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs, rheads, tax = [], [], []
    n_mut = int(0.015 * fam_len)    # 1.5% per member => ~3% pairwise
    for fi in range(n_fam):
        anc = rng.choice(bases, size=fam_len)
        for m in range(n_mem):
            r = anc.copy()
            pos = rng.integers(0, fam_len, n_mut)
            r[pos] = bases[rng.integers(0, 4, n_mut)]
            refs.append(r)
            rheads.append(f"a{fi:05d}m{m:03d}".encode())
            tax.append(
                f"k__Bacteria;p__P{fi % 40};c__C{fi % 160};"
                f"o__O{fi % 400};f__F{fi % 800};g__G{fi};"
                f"s__S{fi}_{m}")
    reads, qheads = [], []
    n_refs = len(refs)
    for i in range(n_reads):
        s = refs[int(rng.integers(0, n_refs))]
        st = int(rng.integers(0, len(s) - A_READ_LEN))
        r = s[st:st + A_READ_LEN].copy()
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, A_READ_LEN))
            r[p] = bases[int(rng.integers(0, 4))]
        reads.append(r)
        qheads.append(f"aq{i:06d}".encode())
    return rheads, refs, tax, qheads, reads


def build_shotgun_db(rheads, refs):
    """(RefData, Accelerator) for the shotgun workload: shear at 320,
    k=12 accelerator."""
    from burst_tpu.accel import build_accelerator
    from burst_tpu.process import process_references

    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=READ_LEN, thres=THRES,
                            rebase=True, rebase_amt=320, curate=2)
    return rd, build_accelerator(rd, k=K, z=1)


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    from burst_tpu.serving import Aligner

    rheads, refs, qheads, reads = make_workload()
    t0 = time.perf_counter()
    rd, acc = build_shotgun_db(rheads, refs)
    build_s = time.perf_counter() - t0
    al = Aligner(rd, acc, thres=THRES, mode="BEST", do_rc=True)
    t0 = time.perf_counter()
    al.align_batch(qheads, [r.copy() for r in reads])   # compile + upload
    warm_s = time.perf_counter() - t0
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        rows = al.align_batch(qheads, [r.copy() for r in reads])
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    print(json.dumps({
        "metric": "100bp reads aligned/s, BEST, both strands, k=12, "
                  f"{sum(len(r) for r in refs) / 1e6:.0f} Mbp family DB",
        "value": len(reads) / best,
        "unit": "reads/s",
        "rows": rows.count(b"\n"),
        "build_s": build_s,
        "first_pass_s": warm_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
