"""Command-line interface, flag-compatible with the reference aligner.

Mirrors /root/reference/burst.c:4902-5164 (main): same flags, same
defaults (CAPITALIST mode, identity 0.97, N penalized). Flags that are
pure performance tuners in the reference (-t/-c/-l) are accepted and
recorded but do not change results, exactly as there.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from . import enable_compile_cache, engine, modes
from .alphabet import score_matrix
from .io.fasta import parse_fasta, parse_fasta_fast
from .io.taxonomy import Taxonomy
from .process import process_queries, process_references


def _usage():
    print("burst_tpu aligner -- accelerated BURST-compatible aligner")
    print("usage: burst_tpu -r refs.fa -q reads.fa -o out.b6 [options]")
    sys.exit(1)


def parse_args(argv):
    a = {
        "mode": "CAPITALIST", "thres": 0.97, "z": 1, "xalpha": False,
        "rc": False, "whitespace": False, "tax": None, "taxacut": 10,
        "taxa_ncbi": False, "taxasuppress": False, "strict": False,
        "ref": None, "query": None, "out": None, "accel": None,
        "makedb": False, "dbtype": "QUICK", "db_qlen": 500,
        "rebase": False, "rebase_amt": 500, "dedupe": False,
        "threads": 1, "skipambig": False, "fp": False, "prepass": 0,
        "heur": False, "quiet": False, "shards": 1, "qshards": 1,
        "latency": 16,
        "kmer": int(os.environ.get("BURST_TPU_SCOUR_N", "15")),
    }
    i = 1
    n = len(argv)

    def need(msg):
        nonlocal i
        i += 1
        if i == n or argv[i].startswith("-"):
            print(f"ERROR: {msg}")
            sys.exit(1)
        return argv[i]

    while i < n:
        arg = argv[i]
        if arg in ("--references", "-r"):
            a["ref"] = need("--references requires filename argument")
        elif arg in ("--queries", "-q"):
            a["query"] = need("--queries requires filename argument")
        elif arg in ("--output", "-o"):
            a["out"] = need("--output requires filename argument")
        elif arg in ("--forwardreverse", "-fr"):
            a["rc"] = True
        elif arg in ("--whitespace", "-w"):
            a["whitespace"] = True
        elif arg in ("--npenalize", "-n"):
            a["z"] = 1
        elif arg in ("--nwildcard", "-y"):
            a["z"] = 0
        elif arg in ("--xalphabet", "-x"):
            a["xalpha"] = True
        elif arg in ("--taxonomy", "-b"):
            a["tax"] = need("--taxonomy requires filename argument")
        elif arg in ("--mode", "-m"):
            m = need("--mode requires an argument")
            if m == "MATRIX":          # burst.c:4963-4964
                print("ERROR: Matrix mode is no longer supported",
                      file=sys.stderr)
                sys.exit(1)
            if m not in ("BEST", "ALLPATHS", "CAPITALIST", "FORAGE", "ANY"):
                print(f"Unsupported run mode '{m}'")
                sys.exit(1)
            a["mode"] = m
        elif arg in ("--makedb", "-d"):
            a["makedb"] = True
            if i + 1 < n and not argv[i + 1].startswith("-") and \
                    not argv[i + 1].lstrip("+-").isdigit():
                i += 1
                if argv[i] in ("DNA", "RNA"):
                    a["dbtype"] = "DNA"
                elif argv[i] == "QUICK":
                    a["dbtype"] = "QUICK"
                else:
                    print(f"Unsupported makedb mode '{argv[i]}'")
                    sys.exit(1)
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                a["db_qlen"] = int(argv[i])
        elif arg in ("--accelerator", "-a"):
            a["accel"] = need("--accelerator requires filename argument")
        elif arg in ("--taxacut", "-bc"):
            v = need("--taxacut requires numeric argument")
            t = int(float(v)) if "." not in v else 0
            if t < 2:
                t = int(1.0 / (1.0 - float(v)) + 0.5)
            if t < 2:
                print("ERROR: taxacut must be >= 2")
                sys.exit(1)
            a["taxacut"] = t
        elif arg in ("--taxa_ncbi", "-bn"):
            a["taxa_ncbi"] = True
        elif arg in ("--skipambig", "-sa"):
            a["skipambig"] = True
        elif arg in ("--taxasuppress", "-bs"):
            a["taxasuppress"] = True
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                if argv[i] == "STRICT":
                    a["strict"] = True
                else:
                    print(f"ERROR: Unrecognized taxasuppress '{argv[i]}'")
                    sys.exit(1)
        elif arg in ("--id", "-i"):
            t = float(need("--id requires decimal argument"))
            if not (0.0 <= t <= 1.0):
                print("Invalid id range [0-1]")
                sys.exit(1)
            a["thres"] = max(t, 0.01)
        elif arg in ("--threads", "-t"):
            a["threads"] = int(need("--threads requires integer argument"))
        elif arg in ("--shear", "-s"):
            a["rebase"] = True
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                a["rebase_amt"] = int(argv[i])
            if a["rebase_amt"] == 0:
                a["rebase"] = False
        elif arg in ("--unique", "-u"):
            a["dedupe"] = True
        elif arg in ("--fingerprint", "-f"):
            a["fp"] = True
        elif arg in ("--prepass", "-p"):
            a["prepass"] = 16
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                a["prepass"] = int(argv[i])
        elif arg in ("--heuristic", "-hr"):
            a["heur"] = True
        elif arg == "--noprogress":
            a["quiet"] = True
        elif arg in ("--cache", "-c"):
            # cacheSz is a pure performance tuner in the reference
            # (prefix-seek row cache, burst.c:5079-5084)
            need("--cache requires integer argument")
        elif arg in ("--latency", "-l"):
            a["latency"] = int(need("--latency requires integer "
                                    "argument"))
        elif arg in ("--clustradius", "-cr"):
            a["clustradius"] = int(need("--clustradius requires "
                                        "integer argument"))
            if a["clustradius"] < 0:
                # the reference atoi's into uint32_t so a negative
                # wraps to ~4e9 EM rounds -- never a useful request;
                # make the accepted domain explicit instead
                print("ERROR: --clustradius must be >= 0",
                      file=sys.stderr)
                sys.exit(1)
            print(" --> Setting FP cluster search radius to "
                  f"{a['clustradius']} members")
            if a["clustradius"]:
                print("    [-cr parity note: EM junk-slot regime is "
                      "controlled by BURST_TPU_EM_TAIL; the default 0 "
                      "matches the single-thread oracle on small DBs]")
        elif arg in ("--dbpartition", "-dp"):
            a["cparts"] = int(need("--dbpartition requires integer "
                                   "argument"))
        elif arg == "--shards":
            a["shards"] = int(need("--shards requires integer argument"))
        elif arg == "--qshards":
            a["qshards"] = int(need("--qshards requires integer "
                                    "argument"))
        elif arg == "--kmer":
            a["kmer"] = int(need("--kmer requires integer argument"))
        elif arg in ("--help", "-h"):
            _usage()
        else:
            print(f"ERROR: Unrecognized command-line option: {arg}")
            sys.exit(1)
        i += 1
    return a


class _Phases:
    """Wall-clock phase tracing (the reference prints omp_get_wtime
    deltas per phase, e.g. burst.c:3003, 5162; --noprogress mutes).
    Set BURST_TPU_PROFILE=<dir> to also capture a jax.profiler trace
    of the whole run."""

    def __init__(self, quiet: bool):
        import time
        self.quiet = quiet
        self.t = time.perf_counter
        self.t0 = self.last = self.t()
        self.prof_dir = os.environ.get("BURST_TPU_PROFILE")
        if self.prof_dir:
            import jax
            jax.profiler.start_trace(self.prof_dir)

    def mark(self, name: str):
        now = self.t()
        if not self.quiet:
            print(f"{name}: {now - self.last:.3f}s")
        self.last = now

    def done(self):
        if self.prof_dir:
            import jax
            jax.profiler.stop_trace()
        if not self.quiet:
            print(f"Total time: {self.t() - self.t0:.3f}s")


def run(a) -> int:
    import burst_tpu.db.edx as edx

    if os.environ.get("BURST_TPU_MULTIHOST"):
        # DB-sharded multi-process run (parallel/multihost.py); every
        # process executes the same CLI line, process 0 writes the b6
        if a["makedb"]:
            print("ERROR: build the database once, without "
                  "BURST_TPU_MULTIHOST")
            return 1
        from .parallel.multihost import align_multihost
        return align_multihost(a)

    ph = _Phases(a["quiet"])
    if a["makedb"]:
        from .db.build import make_db
        make_db(a)
        ph.done()
        return 0

    smat = score_matrix(a["z"])
    qh, qs = parse_fasta_fast(a["query"])
    # prepass never materializes RC twins or accelerator bins
    # (burst.c:3065, 3113)
    qd = process_queries(qh, qs, a["thres"],
                         a["rc"] and not a["prepass"],
                         incl_whitespace=a["whitespace"],
                         xalpha=a["xalpha"])
    ph.mark("Parsed/processed queries")
    if edx.is_edx(a["ref"]):
        rd, dshear = edx.read_edx(a["ref"], xalpha=a["xalpha"])
        if dshear and int(np.float32(qd.max_len) / np.float32(a["thres"])) \
                > dshear:
            print("ERROR: DB incompatible with selected queries/identity.")
            if not a["heur"] and not a["prepass"]:
                return 1
    else:
        rh, rs = parse_fasta(a["ref"])
        rd = process_references(
            rh, rs, max_len_q=qd.max_len, thres=a["thres"],
            rebase=a["rebase"], rebase_amt=a["rebase_amt"],
            curate=1 if a["dedupe"] else 0, xalpha=a["xalpha"],
            do_fp=a["fp"], z=a["z"], latency=a["latency"],
            clustradius=a.get("clustradius", 0))
    ph.mark("Reference database ready")

    taxonomy = None
    if a["tax"]:
        taxonomy = Taxonomy.parse(a["tax"], ncbi=a["taxa_ncbi"])

    if a["prepass"]:
        if not a["accel"]:
            print("ERROR: prepass requires an accelerator (-a)")
            return 1
        from .accel import read_acx
        from .prepass import run_prepass
        acc = read_acx(a["accel"], z_required=a["z"])
        a["smat"] = smat
        with open(a["out"], "w") as fh:
            return run_prepass(qd, rd, acc, a, fh, taxonomy)

    visits = None
    if a["accel"]:
        from .accel import read_acx
        from .process import bin_queries_for_accel
        acc = read_acx(a["accel"], z_required=a["z"])
        qbins = bin_queries_for_accel(qd, acc.k, a["z"], a["heur"])
        fused = None
        if not a["heur"] and a["shards"] <= 1:
            # one dispatch chain when the thread-derived QBUNCH is 1
            fused = engine.accel_scan_fused(qd, rd, acc, qbins, smat,
                                            threads=a["threads"],
                                            skip_ambig=a["skipambig"])
        if fused is not None:
            visits, ed = fused
            ph.mark("Accelerator scour")
        else:
            engine.prefetch_query_planes(qd, smat)  # h2d overlaps scour
            visits = engine.accel_candidates(qd, rd, acc, qbins,
                                             a["heur"],
                                             threads=a["threads"],
                                             skip_ambig=a["skipambig"])
            ph.mark("Accelerator scour")
            if a["shards"] > 1:
                from .parallel.mesh import (
                    compute_ed_matrix_accel_sharded)
                ed = compute_ed_matrix_accel_sharded(
                    qd, rd, visits, smat, a["shards"], a["qshards"])
            else:
                ed = engine.compute_ed_matrix_accel(qd, rd, visits,
                                                    smat)
    elif a["shards"] > 1:
        from .parallel.mesh import compute_ed_matrix_sharded
        ed = compute_ed_matrix_sharded(qd, rd, smat, a["shards"],
                                       q_shards=a["qshards"])
    elif a["mode"] == "ANY":
        ed = engine.compute_ed_matrix(qd, rd, smat)
    else:
        # full path: streamed running-min selection, never the dense
        # [numUnibins, tot_units] matrix (burst.c:4318-4521)
        ed = None
        sel = engine.compute_ed_select(qd, rd, a["mode"], smat)
    ph.mark("Alignment phase A")

    with open(a["out"], "w") as fh:
        writer = modes.B6Writer(fh)
        if a["mode"] == "ANY":
            if isinstance(ed, engine.SparseED):
                n = len(qd.seqs)
                qb = max(1, min(16, n // (max(1, a["threads"]) * 128)))
                modes.report_any_accel(ed, visits, qd, rd, writer, smat,
                                       qbunch=qb)
            else:
                modes.report_any(ed, qd, rd, writer, smat)
            ph.mark("Reporting")
            ph.done()
            return 0
        if ed is None:
            juni, refpos, eds = sel
        else:
            juni, refpos, eds = engine.select_pods(qd, rd, ed, a["mode"])
        pod_order = None
        win_cols = None
        if visits is not None:
            pod_order = engine.accel_pod_order(qd, rd, visits, juni,
                                               refpos, eds)
            win_cols = ed.lookup_cols(juni, refpos, rd.tot_units)
        if a["shards"] > 1 and visits is not None:
            from .parallel.mesh import rescore_winners_sharded
            pods = rescore_winners_sharded(qd, rd, juni, refpos, eds,
                                           a["mode"], smat, a["shards"],
                                           pod_order, a["qshards"],
                                           win_cols=win_cols)
        else:
            pods = engine.rescore_winners(qd, rd, juni, refpos, eds,
                                          a["mode"], smat, pod_order,
                                          win_cols=win_cols)
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
    ph.mark("Rescore + reporting")
    ph.done()
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    if len(argv) < 2:
        _usage()
    enable_compile_cache()
    a = parse_args(argv)
    if not a["out"] or not a["ref"] and not a["makedb"]:
        print("ERROR: missing required arguments")
        return 1
    return run(a)


if __name__ == "__main__":
    sys.exit(main())
