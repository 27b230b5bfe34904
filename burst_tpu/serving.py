"""Serving API: load a database once, align read batches repeatedly.

The reference is a one-shot CLI; production deployment wants the
expensive state (parsed .edx/.acx artifacts, device-resident tiles,
compiled kernels) loaded once and query batches streamed through. The
`Aligner` below owns that state; `align_batch` runs the same pipeline
as the CLI (byte-identical output) and returns blast6 bytes.

    al = Aligner.from_artifacts("db.edx", "db.acx", thres=0.98)
    al.warmup(read_len=100)             # compile kernel shapes ahead
    b6 = al.align_batch(headers, seqs)  # repeat per batch
"""
from __future__ import annotations

import io

import numpy as np

from . import enable_compile_cache, engine, modes
from .alphabet import score_matrix
from .io.taxonomy import Taxonomy
from .process import RefData, bin_queries_for_accel, process_queries


class Aligner:
    def __init__(self, rd: RefData, acc=None, thres: float = 0.97,
                 mode: str = "BEST", do_rc: bool = False,
                 taxonomy: Taxonomy | None = None, z: int = 1,
                 taxacut: int = 10, taxasuppress: bool = False,
                 strict: bool = False):
        enable_compile_cache()
        self.rd = rd
        self.acc = acc
        self.thres = thres
        self.mode = mode
        self.do_rc = do_rc
        self.taxonomy = taxonomy
        self.smat = score_matrix(z)
        self.z = z
        self.taxacut = taxacut
        self.taxasuppress = taxasuppress
        self.strict = strict

    @classmethod
    def from_artifacts(cls, edx_path: str, acx_path: str | None = None,
                       tax_path: str | None = None, **kw):
        """Load persisted .edx (+.acx, +taxonomy TSV) artifacts."""
        from .accel import read_acx
        from .db import edx

        rd, _ = edx.read_edx(edx_path, xalpha=False)
        acc = read_acx(acx_path, z_required=kw.get("z", 1)) \
            if acx_path else None
        tax = Taxonomy.parse(tax_path) if tax_path else None
        return cls(rd, acc, taxonomy=tax, **kw)

    @classmethod
    def from_fasta(cls, ref_path: str, shear: int = 0, **kw):
        """Build the database in-process from a reference FASTA."""
        from .io.fasta import parse_fasta
        from .process import process_references

        rh, rs = parse_fasta(ref_path)
        rd = process_references(
            rh, rs, max_len_q=kw.pop("max_len_q", 320),
            thres=kw.get("thres", 0.97), rebase=shear > 0,
            rebase_amt=shear or 320, curate=2)
        return cls(rd, None, **kw)

    def warmup(self, read_len: int = 100, n: int = 256):
        """Compile the kernel shapes for a typical batch ahead of time.

        Uses ACGT reads: the scour chunk kernels have fixed row shapes,
        so any batch of the production read length compiles them."""
        rng = np.random.default_rng(0)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        seqs = [rng.choice(bases, size=read_len) for _ in range(n)]
        heads = [f"w{i}".encode() for i in range(n)]
        self.align_batch(heads, seqs)

    def align_stream(self, batches, depth: int = 2,
                     alternate: bool = False):
        """Pipelined serving: align an iterable of (headers, seqs)
        batches, yielding each batch's blast6 bytes in order.

        Up to `depth` batches are in flight on worker threads, so one
        batch's host-side work (parsing, scour fallbacks, b6 emission)
        overlaps another's device scans and fetch round-trips -- the
        device-wait portions release the GIL. Batches are independent
        (per-batch dedupe scope), exactly as repeated align_batch
        calls.

        alternate=True routes every other batch through the host
        (native C++) scour instead of the device scour: host and device
        scans of different batches then run concurrently, raising
        aggregate throughput when one CPU core must feed one chip.
        Outputs are byte-identical either way."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max(1, depth)) as ex:
            live = collections.deque()
            for i, batch in enumerate(batches):
                dev = (i % 2 == 0) if alternate else None
                live.append(ex.submit(self.align_batch, *batch,
                                      dev_scour=dev))
                while len(live) > depth:
                    yield live.popleft().result()
            while live:
                yield live.popleft().result()

    def align_batch(self, headers: list[bytes],
                    seqs: list[np.ndarray],
                    dev_scour: bool | None = None) -> bytes:
        """Align one batch of translated-or-raw reads; blast6 bytes.

        `seqs` may be raw ASCII uint8 arrays (translated internally) or
        pre-translated 4-bit code arrays (values < 16). `dev_scour`
        overrides the device-scour policy for this batch (see
        align_stream's alternate mode).
        """
        qd = process_queries(headers, seqs, self.thres, self.do_rc)
        mode = self.mode
        buf = io.StringIO()
        writer = modes.B6Writer(buf)
        if self.acc is not None:
            qbins = bin_queries_for_accel(qd, self.acc.k, self.z)
            # BEST's reporter is pod-order-insensitive, so the QBUNCH=1
            # fused device scan is byte-safe there; other modes keep
            # the reference's thread-derived bunch width
            fused = engine.accel_scan_fused(
                qd, self.rd, self.acc, qbins, self.smat, qbunch=1,
                dev_scour=dev_scour) if mode == "BEST" else None
            if fused is not None:
                visits, ed = fused
            else:
                engine.prefetch_query_planes(qd, self.smat)
                # same argument on the host path: BEST gets QBUNCH=1,
                # which takes the scour's single-walk fast path AND
                # admits per-member-tight candidate sets (a bunch's
                # threshold is the min over its members)
                visits = engine.accel_candidates(
                    qd, self.rd, self.acc, qbins,
                    qbunch=1 if mode == "BEST" else None,
                    dev_scour=dev_scour)
                ed = engine.compute_ed_matrix_accel(
                    qd, self.rd, visits, self.smat, defer=True)
        else:
            visits = None
            ed = engine.compute_ed_matrix(qd, self.rd, self.smat) \
                if mode == "ANY" else None
        if mode == "ANY":
            if isinstance(ed, engine.SparseED):
                modes.report_any_accel(ed, visits, qd, self.rd, writer,
                                       self.smat, qbunch=1)
            else:
                modes.report_any(ed, qd, self.rd, writer, self.smat)
            return buf.getvalue().encode("latin-1")
        if ed is None:
            # non-accel full path: streamed selection, no dense matrix
            juni, refpos, eds = engine.compute_ed_select(
                qd, self.rd, mode, self.smat)
        else:
            juni, refpos, eds = engine.select_pods(qd, self.rd, ed,
                                                   mode)
        pod_order = win_cols = None
        if visits is not None:
            pod_order = engine.accel_pod_order(qd, self.rd, visits,
                                               juni, refpos, eds)
            win_cols = ed.lookup_cols(juni, refpos, self.rd.tot_units)
        pods = engine.rescore_winners(qd, self.rd, juni, refpos, eds,
                                      mode, self.smat, pod_order,
                                      win_cols=win_cols)
        if mode in ("ALLPATHS", "FORAGE"):
            modes.report_allpaths_or_forage(
                pods, qd, self.rd, writer, self.taxonomy,
                forage=(mode == "FORAGE"))
        elif mode == "BEST":
            modes.report_best(pods, qd, self.rd, writer, self.taxonomy,
                              self.taxasuppress, self.strict)
        elif mode == "CAPITALIST":
            modes.report_capitalist(pods, qd, self.rd, writer,
                                    self.taxonomy, self.taxacut,
                                    self.taxasuppress, self.strict)
        else:
            raise ValueError(f"unknown mode {mode}")
        return buf.getvalue().encode("latin-1")
