"""Command-line interface: the scan tool the reference never finished
(its main.cpp prints "Work in progress" — SURVEY.md component #16).

    python -m hmm_fasta_viterbi scan  --hmm P.hmm --fasta DB.fsa
    python -m hmm_fasta_viterbi sweep --hmm-dir profiles/ --fasta DB.fsa
    python -m hmm_fasta_viterbi generate --out random.fsa --count 3
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import pathlib
import sys
import time

import numpy as np

from .io.loader import load_fasta, load_profile
from .models import stats
from .models.msv import MSVProfile
from .pipeline import MSVScanner

logger = logging.getLogger(__name__)


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--fasta", required=True, help="protein FASTA database")
    ap.add_argument(
        "--msv-impl", default="auto", choices=["auto", "cuda", "xla"],
        help="MSV stage implementation: the CUDA kernel (GPU only) or "
        "XLA; auto picks the kernel on a GPU",
    )
    ap.add_argument("--format", default="tsv", choices=["tsv", "json"])
    ap.add_argument("--top", type=int, default=0, help="report only the top K hits (0 = all)")
    ap.add_argument("--max-evalue", type=float, default=None, help="E-value cutoff")
    ap.add_argument(
        "--loader",
        default="auto",
        choices=["auto", "native", "python"],
        help="data loader: native C++ fast path or pure-Python parsers",
    )
    ap.add_argument("--out", default=None, help="write results to FILE instead of stdout")
    ap.add_argument("--config", default=None, help="EngineConfig JSON path")
    ap.add_argument("--profile-trace", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the scan into DIR")
    ap.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="shard scans over a device mesh: 'db=N[,sp=M]' or just 'N' "
        "(db axis size; default uses all devices, e.g. --mesh db=8)",
    )


def _parse_mesh(spec: str) -> dict:
    """'db=8,sp=1' | '8' | 'all' -> make_scan_mesh kwargs."""
    out: dict = {}
    if spec.strip().lower() == "all":
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            if k.strip() not in ("db", "sp"):
                raise ValueError(f"unknown mesh axis {k!r} (use db/sp)")
            out[k.strip()] = int(v)
        else:
            out["db"] = int(part)
    return out


_PVALUE_FNS = {
    "msv": stats.msv_pvalue,
    "viterbi": stats.viterbi_pvalue,
    "forward": stats.forward_pvalue,
}


def _finite_or_none(x) -> float | None:
    """JSON-safe float: stages a row never reached leave NaN p/E-values,
    and json.dump's bare ``NaN`` is invalid JSON for strict parsers —
    emit null instead (ADVICE r3)."""
    x = float(x)
    return x if np.isfinite(x) else None


def _fmt_e(x) -> str:
    """TSV cell for a possibly-null p/E-value."""
    return "nan" if x is None else f"{x:.3e}"


@contextlib.contextmanager
def _out_sink(args):
    """Yield the report sink, opening --out BEFORE the scan runs so a
    bad path fails fast instead of after minutes of compute."""
    path = getattr(args, "out", None)
    if path:
        with open(path, "w") as fh:
            yield fh
    else:
        yield sys.stdout


@contextlib.contextmanager
def _json_accumulator(args, sink):
    """Multi-profile sweeps in JSON format must emit ONE valid document:
    collect every profile's rows and dump a single array at the end."""
    if args.format != "json":
        yield None
        return
    rows: list = []
    try:
        yield rows
    finally:
        # dump even on a mid-sweep failure: --out was already truncated
        # by the fail-fast open, so bailing here would discard every
        # profile computed before the error (ADVICE r1)
        json.dump(rows, sink, indent=1)
        sink.write("\n")


def _report(profile, db, scores: np.ndarray, args, out=None, stage="msv",
            rows_sink=None) -> None:
    out = out if out is not None else sys.stdout
    bits = stats.nats_to_bits(scores)
    pvals = _PVALUE_FNS[stage](scores, profile)
    evals = stats.evalue(pvals, len(db))
    order = np.argsort(-scores)
    if args.top:
        order = order[: args.top]
    rows = []
    for i in order:
        if args.max_evalue is not None and evals[i] > args.max_evalue:
            continue
        rows.append(
            {
                "target": db.records[i].header or f"seq{i}",
                "profile": profile.name,
                "score_nats": round(float(scores[i]), 4),
                "score_bits": round(float(bits[i]), 4),
                "pvalue": _finite_or_none(pvals[i]),
                "evalue": _finite_or_none(evals[i]),
            }
        )
    if args.format == "json":
        if rows_sink is not None:
            rows_sink.extend(rows)
        else:
            json.dump(rows, out, indent=1)
            out.write("\n")
    else:
        out.write("# target\tprofile\tscore_nats\tscore_bits\tpvalue\tevalue\n")
        for r in rows:
            out.write(
                f"{r['target']}\t{r['profile']}\t{r['score_nats']}\t"
                f"{r['score_bits']}\t{_fmt_e(r['pvalue'])}\t{_fmt_e(r['evalue'])}\n"
            )


def _cmd_scan_stream(args) -> int:
    """Streaming scan: the FASTA is read in bounded record batches
    (io.loader.stream_fasta), each staged and scored before the next is
    parsed — host memory holds one batch plus one float and one header
    per sequence, so database size is unbounded. E-values use the true
    total database size, known once the stream ends. All single-score
    stages (msv/viterbi/forward) stream; --stage search streams via
    per-batch compaction to MSV survivors (_cmd_search_stream)."""
    if getattr(args, "bucketed", False) or _sp_mesh(args) is not None:
        logger.error("--stream does not compose with --bucketed or sp>1")
        return 2
    if args.stage == "search":
        return _cmd_search_stream(args)
    from .io.fastaio import FastaDatabase, FastaRecord
    from .io.loader import stream_fasta_prefetch

    hmm = load_profile(args.hmm, prefer=args.loader)
    scanner = _make_scanner(args)
    stage_fn = None
    if args.stage == "msv":
        profile = MSVProfile.from_profile(hmm)
        stage_fn = scanner.stage  # staged off-thread, double-buffered

        def batch_scores(tokens, lengths, staged):
            return np.asarray(scanner.scan(profile, staged))
    else:  # viterbi / forward
        from .models.p7 import P7Profile
        from .ops.p7_scan import forward_xla, viterbi_xla

        p7 = P7Profile.from_profile(hmm)
        p7_fn = viterbi_xla if args.stage == "viterbi" else forward_xla

        def batch_scores(tokens, lengths, staged):
            return np.asarray(p7_fn(p7, tokens, lengths))

    t0 = time.perf_counter()
    headers: list[str] = []
    score_chunks: list[np.ndarray] = []
    total_cells = 0
    # pad_multiple keeps the compiled-shape set small across ragged
    # batches (one executable per 256-residue length bucket); parse +
    # encode (+ stage on the msv path) of the next batch overlap the
    # device scan of this one
    for item in stream_fasta_prefetch(
        args.fasta, args.stream, prefer=args.loader, encode_pad_multiple=256,
        stage_fn=stage_fn,
    ):
        batch, tokens, lengths = item[:3]
        staged = item[3] if stage_fn is not None else None
        if not len(batch):
            continue
        score_chunks.append(batch_scores(tokens, lengths, staged))
        headers.extend(r.header for r in batch.records)
        total_cells += int(lengths.astype(np.int64).sum()) * (
            hmm.model_length - 1
        )
    if not headers:
        logger.warning("no valid sequences in %s", args.fasta)
        return 1
    scores = np.concatenate(score_chunks)
    dt = time.perf_counter() - t0
    logger.info(
        "streamed %d seqs x %s (%s) in %.3fs (%.2f GCUPS)",
        len(headers), hmm.name, args.stage, dt, total_cells / dt / 1e9,
    )
    db = FastaDatabase(
        records=[FastaRecord(h, "") for h in headers], rejected=[]
    )
    with _out_sink(args) as sink:
        _report(hmm, db, scores, args, out=sink, stage=args.stage)
    return 0


@dataclasses.dataclass
class _StreamedSearch:
    """Per-profile aggregate of a streamed cascade: MSV-survivor rows of
    every SearchResult field plus the survivor headers/tokens."""

    result: object  # SearchResult over survivors only
    headers: list
    tokens: np.ndarray | None  # [S, Lmax] survivor tokens (keep_tokens)
    lengths: np.ndarray | None
    n_vit: int
    n_fwd: int


def _stream_search(args, scanner, pipeline, hmms, keep_tokens: bool,
                   timer=None):
    """ONE pass over the streamed FASTA, running the full cascade for
    every profile per batch and compacting host state to that batch's
    MSV survivors — the only rows the search report prints
    (_report_search iterates passed_msv). Host memory is one batch plus
    the survivor sets, so genome-scale searches stream. Per-sequence
    p-values are database-size independent, so pass/fail and every
    reported number match the whole-file scan exactly; survivor token
    rows are retained only when --domains/--align need them.

    Parse + encode + STAGE (pad/upload) of the NEXT batch
    overlap the device scan of the current one
    (io.loader.stream_fasta_prefetch with stage_fn); ``timer`` (a
    runtime.profiling.SectionTimer) attributes the consumer wall to
    prefetch_wait (producer work NOT hidden by device work) / search /
    compact, and the producer's own parse/encode/stage seconds land in
    the same timer under a ``producer/`` prefix after the stream ends.

    Returns ({profile_name: _StreamedSearch}, total_seqs, total_cells).
    """
    from .io.loader import stream_fasta_prefetch
    from .pipeline import SearchResult
    from .runtime.profiling import SectionTimer

    if timer is None:
        timer = SectionTimer()
    fields = [f.name for f in dataclasses.fields(SearchResult)]
    agg = {
        h.name: {
            "kept": {f: [] for f in fields}, "headers": [],
            "tok_rows": [], "len_rows": [], "n_vit": 0, "n_fwd": 0,
        }
        for h in hmms
    }
    total_seqs = 0
    total_cells = 0
    # producer-side attribution lands in the same timer under a
    # "producer/" prefix (parse / encode / put_wait) — prefetch_wait
    # alone cannot distinguish a slow parser from GIL starvation
    producer_secs: dict = {}
    stream = stream_fasta_prefetch(
        args.fasta, args.stream, prefer=args.loader, encode_pad_multiple=256,
        producer_sections=producer_secs, stage_fn=scanner.stage,
    )
    while True:
        with timer.section("prefetch_wait"):
            item = next(stream, None)
        if item is None:
            break
        batch, tokens, lengths, staged = item
        if not len(batch):
            continue
        recs = batch.records
        for hmm in hmms:
            with timer.section("search"):
                res = pipeline.search(hmm, staged, tokens, lengths)
            with timer.section("compact"):
                a = agg[hmm.name]
                surv = np.flatnonzero(res.passed_msv)
                for f in fields:
                    a["kept"][f].append(np.asarray(getattr(res, f))[surv])
                a["headers"].extend(recs[i].header for i in surv)
                if keep_tokens:
                    for i in surv:
                        a["tok_rows"].append(
                            np.array(
                                tokens[i, : int(lengths[i])], dtype=np.int32
                            )
                        )
                        a["len_rows"].append(int(lengths[i]))
                a["n_vit"] += int(res.passed_viterbi.sum())
                a["n_fwd"] += int(res.passed_forward.sum())
        total_seqs += len(batch)
        total_cells += int(lengths.astype(np.int64).sum()) * sum(
            h.model_length - 1 for h in hmms
        )
    # fold producer attribution into the timer (prefixed) so callers —
    # bench.py's stream row in particular — can PROVE the overlap from
    # one report: producer/stage large + consumer prefetch_wait small
    # means staging was hidden behind device work
    for k, v in producer_secs.items():
        timer.sections[f"producer/{k}"] = (
            timer.sections.get(f"producer/{k}", 0.0) + v
        )
    logger.info("streamed search phases: %s", timer.report())
    out = {}
    for hmm in hmms:
        a = agg[hmm.name]
        merged = (
            SearchResult(
                **{f: np.concatenate(a["kept"][f]) for f in fields}
            )
            if total_seqs
            else None
        )
        if keep_tokens:
            l_max = max(a["len_rows"], default=1)
            toks = np.zeros((len(a["tok_rows"]), l_max), dtype=np.int32)
            for r, row in enumerate(a["tok_rows"]):
                toks[r, : row.size] = row
            lens = np.asarray(a["len_rows"], dtype=np.int32)
        else:
            toks = lens = None
        out[hmm.name] = _StreamedSearch(
            result=merged, headers=a["headers"], tokens=toks,
            lengths=lens, n_vit=a["n_vit"], n_fwd=a["n_fwd"],
        )
    return out, total_seqs, total_cells


def _cmd_search_stream(args) -> int:
    """scan --stage search --stream: see _stream_search."""
    from .io.fastaio import FastaDatabase, FastaRecord

    hmm = load_profile(args.hmm, prefer=args.loader)
    scanner = _make_scanner(args)
    pipeline = _make_pipeline(args, scanner, fast=getattr(args, "fast", False))
    keep_tokens = bool(
        getattr(args, "domains", False) or getattr(args, "align", False)
    )
    t0 = time.perf_counter()
    per_hmm, total_seqs, total_cells = _stream_search(
        args, scanner, pipeline, [hmm], keep_tokens
    )
    if not total_seqs:
        logger.warning("no valid sequences in %s", args.fasta)
        return 1
    agg = per_hmm[hmm.name]
    dt = time.perf_counter() - t0
    logger.info(
        "streamed search %s: %d seqs -> %d past MSV -> %d past Viterbi "
        "-> %d hits (%.3fs, %.2f GCUPS msv-equivalent)",
        hmm.name, total_seqs, len(agg.headers), agg.n_vit, agg.n_fwd, dt,
        total_cells / dt / 1e9,
    )
    db = FastaDatabase(
        records=[FastaRecord(h, "") for h in agg.headers], rejected=[]
    )
    with _out_sink(args) as sink:
        _report_search(
            hmm, db, agg.result, args, out=sink, tokens=agg.tokens,
            lengths=agg.lengths, n_targets=total_seqs,
        )
    return 0


def cmd_scan(args) -> int:
    if args.out:
        open(args.out, "w").close()  # fail fast on a bad --out path
    if getattr(args, "msa_out", None) and not (
        args.stage == "search" and getattr(args, "align", False)
    ):
        logger.error("--msa-out requires --stage search --align")
        return 2
    if getattr(args, "stream", 0):
        return _cmd_scan_stream(args)
    hmm = load_profile(args.hmm, prefer=args.loader)
    db = load_fasta(args.fasta, prefer=args.loader)
    if not len(db):
        logger.warning("no valid sequences in %s", args.fasta)
        return 1
    tokens, lengths = db.encode()
    scanner = _make_scanner(args)
    t0 = time.perf_counter()

    from .runtime.profiling import device_trace

    with device_trace(args.profile_trace):
        return _run_scan_stage(args, hmm, db, tokens, lengths, scanner, t0)


def _stage_bucketed_logged(scanner, tokens, lengths):
    bucketed = scanner.stage_bucketed(tokens, lengths)
    logger.info(
        "bucketed staging: %d buckets, %.0f%% padded cells saved",
        len(bucketed.buckets), 100 * bucketed.padded_cells_saved,
    )
    return bucketed


def _sp_mesh(args):
    """The (db, sp) mesh when --mesh requests sp > 1 — served by the
    wavefront scans (scan --stage msv/viterbi/forward), not the
    scanner's db sharding."""
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    kwargs = _parse_mesh(spec)
    if kwargs.get("sp", 1) <= 1:
        return None
    from .parallel.mesh import make_scan_mesh

    return make_scan_mesh(**kwargs)


def _make_pipeline(args, scanner, fast: bool = False):
    """SearchPipeline honoring --config cascade thresholds (msv_p /
    viterbi_p / forward_p) when a config file is given."""
    from .pipeline import SearchPipeline

    kw = dict(fast_msv=fast, fast_viterbi=fast)
    if getattr(args, "config", None):
        from .runtime.config import EngineConfig

        cfg = EngineConfig.from_json(args.config)
        kw.update(
            msv_p=cfg.msv_p, viterbi_p=cfg.viterbi_p, forward_p=cfg.forward_p
        )
    return SearchPipeline(scanner, **kw)


def _make_scanner(args) -> MSVScanner:
    mesh = None
    if getattr(args, "mesh", None):
        kwargs = _parse_mesh(args.mesh)
        if kwargs.get("sp", 1) > 1:
            # sp sharding routes through the seqblock wavefront
            # (_sp_mesh); the scanner itself stays meshless
            kwargs = None
        if kwargs is not None:
            from .parallel.mesh import make_scan_mesh

            kwargs.pop("sp", None)
            mesh = make_scan_mesh(**kwargs)
            logger.info("mesh: %s", dict(mesh.shape))
    if getattr(args, "config", None):
        from .runtime.config import EngineConfig

        cfg = EngineConfig.from_json(args.config)
        if args.msv_impl != "auto":
            cfg.msv_impl = args.msv_impl
        scanner = MSVScanner.from_config(cfg)
        if mesh is not None and scanner.mesh is None:
            scanner = MSVScanner(
                msv_impl=scanner.msv_impl, l_chunk=scanner.l_chunk, mesh=mesh,
            )
        return scanner
    return MSVScanner(msv_impl=args.msv_impl, mesh=mesh)


def _run_scan_stage(args, hmm, db, tokens, lengths, scanner, t0) -> int:
    sp_mesh = _sp_mesh(args)
    if sp_mesh is not None:
        # residue blocks sharded over sp (+ batch over db): the MSV
        # wavefront pipeline, for sequences too long for one device
        logger.info("sp wavefront mesh: %s", dict(sp_mesh.shape))
        if getattr(args, "bucketed", False):
            logger.error("--bucketed does not compose with --mesh sp>1")
            return 2
        if args.stage != "msv":
            logger.error(
                "--mesh sp>1 serves the msv stage only: the %s stage has "
                "no sequence-parallel wavefront", args.stage,
            )
            return 2
        from .parallel.seqblocks import msv_scan_seqblocks

        scores = msv_scan_seqblocks(
            MSVProfile.from_profile(hmm), tokens, lengths, sp_mesh
        )
        dt = time.perf_counter() - t0
        cells = int(lengths.astype(np.int64).sum()) * (hmm.model_length - 1)
        logger.info(
            "scanned %d seqs x %s (%s, sp wavefront) in %.3fs (%.2f GCUPS)",
            len(db), hmm.name, args.stage, dt, cells / dt / 1e9,
        )
        with _out_sink(args) as sink:
            _report(hmm, db, scores, args, out=sink, stage=args.stage)
        return 0
    if args.stage == "msv":
        profile = MSVProfile.from_profile(hmm)
        if getattr(args, "bucketed", False):
            bucketed = _stage_bucketed_logged(scanner, tokens, lengths)
            scores = scanner.scan_bucketed(profile, bucketed)
        else:
            staged = scanner.stage(tokens, lengths)
            scores = np.asarray(scanner.scan(profile, staged))
    elif args.stage in ("viterbi", "forward"):
        from .models.p7 import P7Profile

        p7 = P7Profile.from_profile(hmm)
        staged = scanner.stage(tokens, lengths)
        scores = np.asarray(scanner.scan_p7(p7, staged, stage=args.stage))
    else:  # search: full MSV -> Viterbi -> Forward cascade
        pipeline = _make_pipeline(args, scanner, fast=getattr(args, "fast", False))
        if getattr(args, "bucketed", False):
            bucketed = _stage_bucketed_logged(scanner, tokens, lengths)
            result = pipeline.search_bucketed(hmm, bucketed, tokens, lengths)
        else:
            staged = scanner.stage(tokens, lengths)
            result = pipeline.search(hmm, staged, tokens, lengths)
        dt = time.perf_counter() - t0
        logger.info(
            "search %s: %d seqs -> %d past MSV -> %d past Viterbi -> %d hits (%.3fs)",
            hmm.name,
            len(db),
            int(result.passed_msv.sum()),
            int(result.passed_viterbi.sum()),
            int(result.passed_forward.sum()),
            dt,
        )
        with _out_sink(args) as sink:
            _report_search(
                hmm, db, result, args, out=sink, tokens=tokens,
                lengths=lengths,
            )
        return 0

    dt = time.perf_counter() - t0
    cells = int(lengths.astype(np.int64).sum()) * (hmm.model_length - 1)
    logger.info(
        "scanned %d seqs x %s (%s) in %.3fs (%.2f GCUPS)",
        len(db), hmm.name, args.stage, dt, cells / dt / 1e9,
    )
    with _out_sink(args) as sink:
        _report(hmm, db, scores, args, out=sink, stage=args.stage)
    return 0


def _coverage_segments(cov_row: np.ndarray, length: int) -> list:
    """1-based (from, to) spans of contiguous positions with summed
    match-posterior coverage >= 0.5 (HMMER-envelope-style: the position
    sits in the model core with posterior majority). Each segment is one
    domain of the multihit (nu = 2) model."""
    covered = cov_row[:length] >= 0.5
    idx = np.flatnonzero(covered)
    if not idx.size:
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [idx.size - 1]))
    return [(int(idx[s]) + 1, int(idx[e]) + 1) for s, e in zip(starts, ends)]


def _envelope_from_coverage(cov_row: np.ndarray, length: int):
    """(env_from, env_to, ndom) summary of :func:`_coverage_segments`."""
    segs = _coverage_segments(cov_row, length)
    if not segs:
        return None
    return segs[0][0], segs[-1][1], len(segs)


def _hit_envelopes(p7, tokens, lengths, hit_idx: np.ndarray) -> dict:
    """Batched posterior decode of all hits: one device call per hit
    chunk instead of a per-hit forward+backward loop — --domains wall
    time is sublinear in hit count (ops.p7_scan vmapped decode)."""
    if not hit_idx.size:
        return {}
    from .ops.p7_scan import posterior_coverage_batch_xla

    l_max = max(int(lengths[hit_idx].max()), 1)
    cov, _ = posterior_coverage_batch_xla(
        p7, tokens[hit_idx, :l_max], lengths[hit_idx]
    )
    return {
        int(i): _coverage_segments(cov[k], int(lengths[i]))
        for k, i in enumerate(hit_idx)
    }


def _domain_scores(p7, tokens, lengths, segments: dict) -> dict:
    """Per-domain Forward scores: each envelope span rescored as its own
    subsequence in ONE batched forward call (HMMER's envelope-rescoring
    shape; domains are few so the batch is small). Returns
    {(hit_index, domain_rank): score_nats}."""
    from .ops.p7_scan import forward_xla

    spans = [
        (i, k, f, t)
        for i, segs in segments.items()
        for k, (f, t) in enumerate(segs)
    ]
    if not spans:
        return {}
    max_len = max(t - f + 1 for _, _, f, t in spans)
    sub = np.zeros((len(spans), max_len), dtype=np.int32)
    sub_len = np.zeros(len(spans), dtype=np.int32)
    for r, (i, _, f, t) in enumerate(spans):
        sub[r, : t - f + 1] = tokens[i, f - 1 : t]
        sub_len[r] = t - f + 1
    scores = np.asarray(forward_xla(p7, sub, sub_len))
    return {
        (i, k): float(scores[r]) for r, (i, k, _, _) in enumerate(spans)
    }


def _report_search(hmm, db, result, args, out=None, tokens=None, lengths=None,
                   rows_sink=None, n_targets: int | None = None) -> None:
    """``n_targets`` is the TRUE database size for E-values — streamed
    searches pass it explicitly since their ``db`` holds only the MSV
    survivors (whole-file callers default to len(db))."""
    out = out if out is not None else sys.stdout
    n_db = n_targets if n_targets is not None else len(db)
    evals = stats.evalue(result.forward_pvalues, n_db)
    want_domains = bool(getattr(args, "domains", False)) and tokens is not None
    want_align = bool(getattr(args, "align", False)) and tokens is not None
    p7 = p7_align = None
    if want_domains or want_align:
        from .models.p7 import P7Profile

        p7_align = P7Profile.from_profile(hmm)
        if want_domains:
            p7 = p7_align
    order = np.flatnonzero(result.passed_msv)
    order = order[np.argsort(-np.nan_to_num(result.forward_scores[order], nan=-np.inf))]
    if args.top:
        order = order[: args.top]
    if args.max_evalue is not None:
        # NaN E-values (Forward never ran on the row) drop too: a
        # sequence rejected mid-cascade cannot satisfy an E cutoff
        order = order[evals[order] <= args.max_evalue]
    # decode only the hits that survive --top/--max-evalue: envelopes
    # and rescoring are O(L*M) device work per hit
    reported_hits = order[result.passed_forward[order]]
    envelopes = (
        _hit_envelopes(p7, tokens, lengths, reported_hits)
        if want_domains
        else {}
    )
    dom_scores = (
        _domain_scores(p7, tokens, lengths, envelopes)
        if want_domains
        else {}
    )
    rows = []
    for i in order:
        row = {
            "target": db.records[i].header or f"seq{i}",
            "profile": hmm.name,
            "msv_bits": round(float(stats.nats_to_bits(result.msv_scores[i])), 4),
            "msv_p": _finite_or_none(result.msv_pvalues[i]),
            "viterbi_p": _finite_or_none(result.viterbi_pvalues[i]),
            "forward_p": _finite_or_none(result.forward_pvalues[i]),
            "evalue": _finite_or_none(evals[i]),
            "hit": bool(result.passed_forward[i]),
        }
        if want_domains and result.passed_forward[i]:
            segs = envelopes.get(int(i)) or []
            if segs:
                row["env_from"], row["env_to"], row["ndom"] = (
                    segs[0][0], segs[-1][1], len(segs)
                )
            else:
                row["env_from"], row["env_to"], row["ndom"] = 0, 0, 0
            doms_out = []
            for k, (f, t) in enumerate(segs):
                s = dom_scores.get((int(i), k), 0.0)
                # per-domain i-Evalue: the envelope-rescored Forward
                # score through the same exp-tail calibration x the
                # true database size (HMMER's independent E-value shape)
                dp = float(stats.forward_pvalue(np.float64(s), hmm))
                doms_out.append(
                    {
                        "env_from": f,
                        "env_to": t,
                        "score_nats": round(float(s), 4),
                        "score_bits": round(
                            float(stats.nats_to_bits(s)), 4
                        ),
                        "ievalue": dp * n_db,
                    }
                )
            row["domains"] = doms_out
        if want_align and result.passed_forward[i]:
            # host-side Viterbi traceback per reported hit (the device
            # scans millions; the few survivors get O(L*M) NumPy
            # alignments — ops.traceback). Past the DP budget it falls
            # back to the posterior envelopes when --domains decoded them
            from .ops.traceback import alignment_row, hit_alignments

            try:
                doms = hit_alignments(
                    p7_align, tokens[i, : int(lengths[i])],
                    envelopes=envelopes.get(int(i)),
                )
            except MemoryError as exc:
                logger.warning("alignment skipped for %s: %s",
                               row["target"], exc)
                doms = []
            row["alignments"] = [alignment_row(d) for d in doms]
        rows.append(row)
    msa_path = getattr(args, "msa_out", None)
    if msa_path and want_align:
        # hmmsearch -A: one Stockholm MSA over every hit domain
        from .ops.traceback import stockholm_msa

        entries = [
            (r["target"], a) for r in rows for a in r.get("alignments", [])
        ]
        with open(msa_path, "w") as fh:
            fh.write(stockholm_msa(entries, p7_align.num_states, hmm.name))
        logger.info("wrote %d aligned domains to %s", len(entries), msa_path)
    if args.format == "json":
        if rows_sink is not None:
            rows_sink.extend(rows)
        else:
            json.dump(rows, out, indent=1)
            out.write("\n")
    else:
        cols = ("# target\tprofile\tmsv_bits\tmsv_p\tviterbi_p\tforward_p"
                "\tevalue\thit")
        if want_domains:
            cols += "\tenv_from\tenv_to\tndom\tdom_scores"
        out.write(cols + "\n")
        for r in rows:
            line = (
                f"{r['target']}\t{r['profile']}\t{r['msv_bits']}\t"
                f"{_fmt_e(r['msv_p'])}\t"
                f"{_fmt_e(r['viterbi_p'])}\t{_fmt_e(r['forward_p'])}\t"
                f"{_fmt_e(r['evalue'])}\t{int(r['hit'])}"
            )
            if want_domains:
                doms = ";".join(
                    f"{d['env_from']}-{d['env_to']}:{d['score_nats']}"
                    for d in r.get("domains", [])
                )
                line += (
                    f"\t{r.get('env_from', '')}\t{r.get('env_to', '')}"
                    f"\t{r.get('ndom', '')}\t{doms}"
                )
            out.write(line + "\n")
        if want_align:
            from .ops.traceback import format_alignment

            for r in rows:
                for k, a in enumerate(r.get("alignments", [])):
                    out.write(
                        f"\n== {r['target']} domain {k + 1} "
                        f"[hmm {a['hmm_from']}-{a['hmm_to']} / "
                        f"seq {a['seq_from']}-{a['seq_to']}]\n"
                    )
                    out.write(
                        format_alignment(a, hmm.name, r["target"]) + "\n"
                    )


def _cmd_sweep_stream(args, hmms) -> int:
    """Streaming sweep: ONE pass over the FASTA; each batch is staged
    once and scanned by every profile (msv: the stacked scan_many
    kernel, i.e. the shard-outer staging economics of resumable_sweep;
    search: the cascade per profile with per-batch compaction to MSV
    survivors). Host memory is one batch plus per-profile results, so
    a whole-Pfam sweep over an unbounded database streams. Flag
    conflicts are rejected by cmd_sweep before profiles are loaded."""
    from .io.fastaio import FastaDatabase, FastaRecord
    from .io.loader import stream_fasta_prefetch

    scanner = _make_scanner(args)
    t0 = time.perf_counter()
    if getattr(args, "stage", "msv") == "search":
        pipeline = _make_pipeline(
            args, scanner, fast=getattr(args, "fast", False)
        )
        per_hmm, total_seqs, _cells = _stream_search(
            args, scanner, pipeline, hmms, keep_tokens=False
        )
        if not total_seqs:
            logger.warning("no valid sequences in %s", args.fasta)
            return 1
        logger.info(
            "streamed search sweep: %d profiles x %d seqs in %.3fs",
            len(hmms), total_seqs, time.perf_counter() - t0,
        )
        with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
            for hmm in hmms:
                agg = per_hmm[hmm.name]
                db = FastaDatabase(
                    records=[FastaRecord(h, "") for h in agg.headers],
                    rejected=[],
                )
                _report_search(
                    hmm, db, agg.result, args, out=sink, rows_sink=acc,
                    n_targets=total_seqs,
                )
        return 0
    profiles = [MSVProfile.from_profile(h) for h in hmms]
    score_chunks: dict[str, list[np.ndarray]] = {p.name: [] for p in profiles}
    headers: list[str] = []
    total_cells = 0
    for batch, tokens, lengths, staged in stream_fasta_prefetch(
        args.fasta, args.stream, prefer=args.loader, encode_pad_multiple=256,
        stage_fn=scanner.stage,
    ):
        if not len(batch):
            continue
        results = scanner.scan_many(profiles, staged)
        for p in profiles:
            score_chunks[p.name].append(np.asarray(results[p.name]))
        headers.extend(r.header for r in batch.records)
        total_cells += int(lengths.astype(np.int64).sum()) * sum(
            h.model_length - 1 for h in hmms
        )
    if not headers:
        logger.warning("no valid sequences in %s", args.fasta)
        return 1
    dt = time.perf_counter() - t0
    logger.info(
        "streamed sweep: %d profiles x %d seqs in %.3fs (%.2f GCUPS)",
        len(profiles), len(headers), dt, total_cells / dt / 1e9,
    )
    db = FastaDatabase(
        records=[FastaRecord(h, "") for h in headers], rejected=[]
    )
    with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
        for p in profiles:
            _report(
                p, db, np.concatenate(score_chunks[p.name]), args,
                out=sink, rows_sink=acc,
            )
    return 0


def _load_sweep_profiles(args) -> list | None:
    """The sweep's profile collection: --hmm-dir (directory of per-model
    files, the reference layout) or --hmm-db (ONE concatenated
    //-separated database file, the hmmscan Pfam.hmm shape)."""
    hmm_db = getattr(args, "hmm_db", None)
    if bool(hmm_db) == bool(args.hmm_dir):
        logger.error("sweep needs exactly one of --hmm-dir / --hmm-db")
        return None
    if args.hmm_dir and not pathlib.Path(args.hmm_dir).is_dir():
        logger.error("--hmm-dir %s is not a directory", args.hmm_dir)
        return []
    if hmm_db and not pathlib.Path(hmm_db).is_file():
        logger.error("--hmm-db %s is not a file", hmm_db)
        return []
    from .io.loader import load_profiles

    hmms = load_profiles(hmm_db or args.hmm_dir, prefer=args.loader)
    if not hmms:
        logger.error("no profiles in %s", hmm_db or args.hmm_dir)
        return hmms
    # every sweep path aggregates results by NAME; a duplicate would
    # crash the streamed merge and silently garble checkpoint shards
    seen: dict[str, int] = {}
    for h in hmms:
        seen[h.name] = seen.get(h.name, 0) + 1
    dupes = sorted(n for n, c in seen.items() if c > 1)
    if dupes:
        logger.error(
            "duplicate profile NAME(s) in %s: %s",
            hmm_db or args.hmm_dir, ", ".join(dupes),
        )
        return None
    return hmms


def cmd_sweep(args) -> int:
    if args.out:
        open(args.out, "w").close()  # fail fast on a bad --out path
    # flag-conflict checks BEFORE loading the profile collection: a
    # Pfam-scale --hmm-db must not be parsed just to reject the flags
    if getattr(args, "stream", 0) and (
        getattr(args, "bucketed", False)
        or _sp_mesh(args) is not None
        or getattr(args, "checkpoint", None)
    ):
        logger.error(
            "--stream does not compose with --bucketed, --checkpoint, "
            "or sp>1"
        )
        return 2
    if getattr(args, "checkpoint", None) and getattr(args, "bucketed", False):
        # the checkpoint path restages per shard by design; silently
        # dropping the requested bucketing would betray the flag
        logger.error("--checkpoint does not compose with --bucketed")
        return 2
    hmms = _load_sweep_profiles(args)
    if hmms is None:
        return 2
    if not hmms:
        return 1
    if getattr(args, "stream", 0):
        return _cmd_sweep_stream(args, hmms)
    db = load_fasta(args.fasta, prefer=args.loader)
    sp_mesh = _sp_mesh(args)
    if sp_mesh is not None:
        if getattr(args, "bucketed", False):
            logger.error("--bucketed does not compose with --mesh sp>1")
            return 2
        if getattr(args, "stage", "msv") != "msv":
            logger.error(
                "--mesh sp>1 serves the msv stage only: the search "
                "cascade's Viterbi and Forward stages have no "
                "sequence-parallel wavefront"
            )
            return 2
        from .parallel.seqblocks import SeqblockScanner

        scanner = SeqblockScanner(sp_mesh)
        logger.info("sweep over sp wavefront mesh: %s", dict(sp_mesh.shape))
    else:
        scanner = _make_scanner(args)
    tokens, lengths = db.encode()
    # NOTE: no up-front staging here — the checkpoint path restages per
    # shard (the whole point of bounding resident/upload cost) and the
    # bucketed path stages its own buckets
    if getattr(args, "stage", "msv") == "search":
        # hmmscan-shaped sweep: the full cascade per profile against the
        # one staged database
        pipeline = _make_pipeline(args, scanner, fast=getattr(args, "fast", False))
        if getattr(args, "checkpoint", None):
            # resumable cascade sweep: per-(profile, shard) SearchResults
            # publish atomically; kill + rerun skips completed chunks
            from .runtime.checkpoint import (
                ScanCheckpoint,
                resumable_search_sweep,
            )

            results = resumable_search_sweep(
                pipeline, hmms, tokens, lengths,
                ScanCheckpoint(args.checkpoint),
                shard_size=args.checkpoint_shard,
            )
            with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
                for hmm in hmms:
                    _report_search(
                        hmm, db, results[hmm.name], args, out=sink,
                        rows_sink=acc,
                    )
            return 0
        if getattr(args, "bucketed", False):
            bucketed = _stage_bucketed_logged(scanner, tokens, lengths)
            run = lambda hmm: pipeline.search_bucketed(
                hmm, bucketed, tokens, lengths
            )
        else:
            staged = scanner.stage(tokens, lengths)
            run = lambda hmm: pipeline.search(hmm, staged, tokens, lengths)
        with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
            for hmm in hmms:
                result = run(hmm)
                logger.info(
                    "search %s: %d past MSV -> %d past Viterbi -> %d hits",
                    hmm.name,
                    int(result.passed_msv.sum()),
                    int(result.passed_viterbi.sum()),
                    int(result.passed_forward.sum()),
                )
                _report_search(hmm, db, result, args, out=sink, rows_sink=acc)
        return 0
    if getattr(args, "checkpoint", None):
        # resumable sweep: per-(profile, shard) results publish
        # atomically; kill + rerun skips completed chunks
        from .runtime.checkpoint import ScanCheckpoint, resumable_sweep

        profiles = [MSVProfile.from_profile(h) for h in hmms]
        results = resumable_sweep(
            scanner, profiles, tokens, lengths,
            ScanCheckpoint(args.checkpoint),
            shard_size=args.checkpoint_shard,
        )
        with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
            for profile in profiles:
                _report(
                    profile, db, results[profile.name], args,
                    out=sink, rows_sink=acc,
                )
        return 0
    bucketed = None
    if getattr(args, "bucketed", False):
        bucketed = _stage_bucketed_logged(scanner, tokens, lengths)
    profiles = [MSVProfile.from_profile(h) for h in hmms]
    if bucketed is not None:
        # stacked multi-profile kernel per (M bucket x length bucket):
        # the sweep24 optimization composed with ragged staging
        results = scanner.scan_many_bucketed(profiles, bucketed)
    else:
        results = scanner.scan_many(profiles, scanner.stage(tokens, lengths))
    with _out_sink(args) as sink, _json_accumulator(args, sink) as acc:
        for profile in profiles:
            _report(
                profile, db, results[profile.name], args,
                out=sink, rows_sink=acc,
            )
    return 0


def cmd_info(args) -> int:
    """hmmstat-shaped profile summary: one row per .hmm with the parsed
    header fields (NAME/LENG) and the three STATS LOCAL calibration
    pairs the P-values are computed from (models.stats). --consensus
    adds the model consensus string (ops.traceback.consensus_string)."""
    hmm_db = getattr(args, "hmm_db", None)
    if sum(bool(x) for x in (args.hmm, args.hmm_dir, hmm_db)) != 1:
        logger.error("info needs exactly one of --hmm / --hmm-dir / --hmm-db")
        return 2
    if args.hmm_dir:
        units = [
            (p.name, load_profile(p, prefer=args.loader))
            for p in sorted(pathlib.Path(args.hmm_dir).glob("*.hmm"))
        ]
    elif hmm_db:
        from .io.loader import load_profiles

        units = [
            (pathlib.Path(hmm_db).name, h)
            for h in load_profiles(hmm_db, prefer=args.loader)
        ]
    else:
        units = [
            (
                pathlib.Path(args.hmm).name,
                load_profile(args.hmm, prefer=args.loader),
            )
        ]
    if not units:
        logger.error("no .hmm files in %s", args.hmm_dir)
        return 1
    rows = []
    for fname, hmm in units:
        row = {
            "file": fname,
            "name": hmm.name,
            "leng": hmm.model_length - 1,
            "model_length": hmm.model_length,
            "msv_mu": hmm.stats_local_msv_mu,
            "msv_lambda": hmm.stats_local_msv_lambda,
            "viterbi_mu": hmm.stats_local_viterbi_mu,
            "viterbi_lambda": hmm.stats_local_viterbi_lambda,
            "forward_tau": hmm.stats_local_forward_theta,
            "forward_lambda": hmm.stats_local_forward_lambda,
        }
        if args.consensus:
            from .models.p7 import P7Profile
            from .ops.traceback import consensus_string

            row["consensus"] = consensus_string(P7Profile.from_profile(hmm))
        rows.append(row)
    with _out_sink(args) as sink:
        out = sink if sink is not None else sys.stdout
        if args.format == "json":
            json.dump(rows, out, indent=1)
            out.write("\n")
        else:
            cols = list(rows[0].keys())
            out.write("# " + "\t".join(cols) + "\n")
            for r in rows:
                out.write("\t".join(str(r[c]) for c in cols) + "\n")
    return 0


def cmd_align(args) -> int:
    """hmmalign-shaped utility: Viterbi-align EVERY sequence of a FASTA
    to one profile (no cascade/thresholds — use `scan --stage search
    --align` for hit-gated reports). Pure host path: alignment is
    per-sequence argmax bookkeeping, which belongs on the CPU
    (ops.traceback module docstring)."""
    from .models.p7 import P7Profile
    from .ops.traceback import (
        alignment_row,
        domain_alignments,
        format_alignment,
        stockholm_msa,
    )

    hmm = load_profile(args.hmm, prefer=args.loader)
    p7 = P7Profile.from_profile(hmm)
    if getattr(args, "stream", 0):
        # bounded host memory: one FASTA batch of raw tokens at a time
        # (alignment output is written/accumulated per record either way)
        from .io.loader import stream_fasta

        def units():
            for batch in stream_fasta(
                args.fasta, args.stream, prefer=args.loader
            ):
                if not len(batch):
                    continue
                toks, lens = batch.encode()
                recs = batch.records
                for i in range(len(batch)):
                    yield (
                        recs[i].header or f"seq{i}",
                        toks[i, : int(lens[i])],
                    )
    else:
        db = load_fasta(args.fasta, prefer=args.loader)
        tokens, lengths = db.encode()

        def units():
            for i in range(len(db)):
                yield (
                    db.records[i].header or f"seq{i}",
                    tokens[i, : int(lengths[i])],
                )

    rows = []
    msa_entries = []
    with _out_sink(args) as sink:
        out = sink if sink is not None else sys.stdout
        for name, seq_tokens in units():
            try:
                score, doms = domain_alignments(p7, seq_tokens)
            except MemoryError as exc:
                # one over-budget sequence (L*M traceback DP) must not
                # discard the whole run's output (scan --align degrades
                # the same way)
                logger.warning("alignment skipped for %s: %s", name, exc)
                score, doms = float("nan"), []
            if args.format == "json":
                rows.append({
                    "target": name,
                    "profile": hmm.name,
                    "viterbi_nats": round(score, 4) if np.isfinite(score) else None,
                    "alignments": [alignment_row(d) for d in doms],
                })
            elif args.format == "stockholm":
                msa_entries.extend((name, d) for d in doms)
            else:
                for k, d in enumerate(doms):
                    out.write(
                        f"== {name} domain {k + 1} "
                        f"[hmm {d.hmm_from}-{d.hmm_to} / "
                        f"seq {d.seq_from}-{d.seq_to}]\n"
                    )
                    out.write(format_alignment(d, hmm.name, name) + "\n")
        if args.format == "json":
            json.dump(rows, out, indent=1)
            out.write("\n")
        elif args.format == "stockholm":
            out.write(stockholm_msa(msa_entries, p7.num_states, hmm.name))
    return 0


def cmd_build(args) -> int:
    """hmmbuild-shaped: construct a profile from an MSA (Stockholm with
    #=GC RF — the shape `align --format stockholm` emits — or aligned
    FASTA), calibrate its STATS by simulation with this engine's own
    kernels, and write an HMMER3/b .hmm file readable by both this
    parser and the reference's (io.hmmwrite round-trip contract)."""
    from .io.hmmwrite import write_hmm
    from .io.msaio import read_msa
    from .models.build import build_profile, calibrate_profile

    names, rows, rf = read_msa(args.msa)
    name = args.name or pathlib.Path(args.msa).stem
    hmm = build_profile(rows, rf=rf, name=name, weighting=args.weighting)
    hmm = calibrate_profile(hmm, seed=args.seed)
    write_hmm(hmm, args.out)
    logger.info(
        "built %s: LENG %d from %d aligned rows (%s match columns), "
        "calibrated MSV mu=%.2f",
        name, hmm.model_length - 1, len(rows),
        "RF" if rf else "gap-majority", hmm.stats_local_msv_mu,
    )
    print(f"wrote {name} (LENG {hmm.model_length - 1}) to {args.out}")
    return 0


def cmd_emit(args) -> int:
    """hmmemit-shaped: sample sequences from the core profile (the
    generative walk over the parsed transition/emission rows —
    models.sample), or its consensus with --consensus. The profile is
    parsed with star_as_zero_prob=True so '*' transitions are
    impossibilities, not the reference's exp(-0)=1 quirk."""
    from .io.alphabet import decode_sequence
    from .io.fastaio import FastaRecord, write_fasta
    from .io.hmmio import parse_hmm

    hmm = parse_hmm(args.hmm, star_as_zero_prob=True)
    if args.consensus:
        from .models.p7 import P7Profile
        from .ops.traceback import consensus_string

        seqs = [consensus_string(P7Profile.from_profile(hmm))]
        names = [f"{hmm.name}-consensus"]
    else:
        from .models.sample import sample_sequences

        toks = sample_sequences(hmm, args.count, args.seed)
        seqs = [decode_sequence(t) for t in toks]
        names = [f"{hmm.name}-sample{i + 1}" for i in range(len(seqs))]
    records = [FastaRecord(n, s) for n, s in zip(names, seqs)]
    if args.out:
        write_fasta(args.out, records, args.width)
        print(f"wrote {len(records)} sequence(s) to {args.out}")
    else:
        write_fasta(sys.stdout, records, args.width)
    return 0


def cmd_generate(args) -> int:
    # lazily import: tools/ is not a package
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
    from generate_fasta import generate_records

    from .io.fastaio import write_fasta

    write_fasta(args.out, generate_records(args.count, args.length, args.seed), args.width)
    print(f"wrote {args.count} x {args.length} aa to {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hmm_fasta_viterbi", description=__doc__)
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="command", required=True)

    scan = sub.add_parser("scan", help="scan a FASTA database against one profile")
    scan.add_argument("--hmm", required=True, help="HMMER3 .hmm profile")
    scan.add_argument(
        "--stage",
        default="msv",
        choices=["msv", "viterbi", "forward", "search"],
        help="scoring stage: single filter or the full search cascade",
    )
    scan.add_argument(
        "--fast",
        action="store_true",
        help="search stage: score MSV and Viterbi through the prefilter "
        "entry points (both exact, so the hits are the same)",
    )
    scan.add_argument(
        "--domains",
        action="store_true",
        help="search stage: posterior-decode an alignment envelope per hit",
    )
    scan.add_argument(
        "--align",
        action="store_true",
        help="search stage: report per-domain Viterbi alignments "
        "(host-side traceback of each hit)",
    )
    scan.add_argument(
        "--msa-out",
        default=None,
        metavar="FILE",
        help="with --align: write one Stockholm MSA of all hit domains "
        "(the hmmsearch -A product)",
    )
    scan.add_argument(
        "--bucketed",
        action="store_true",
        help="length-bucketed staging for ragged databases "
        "(msv/search stages)",
    )
    scan.add_argument(
        "--stream",
        type=int,
        default=0,
        metavar="N",
        help="stream the FASTA in batches of N records (bounded host "
        "memory for databases too large to load whole; search keeps "
        "only MSV survivors between batches)",
    )
    _add_common(scan)
    scan.set_defaults(fn=cmd_scan)

    sweep = sub.add_parser(
        "sweep",
        help="scan a FASTA database against a profile directory or a "
        "concatenated .hmm database",
    )
    sweep.add_argument("--hmm-dir", default=None,
                       help="directory of per-model .hmm files")
    sweep.add_argument(
        "--hmm-db", default=None, metavar="FILE",
        help="ONE concatenated //-separated .hmm database (the hmmscan "
        "Pfam.hmm shape)",
    )
    sweep.add_argument(
        "--stage",
        default="msv",
        choices=["msv", "search"],
        help="msv scores per profile, or the full cascade (hmmscan-shaped)",
    )
    sweep.add_argument(
        "--fast",
        action="store_true",
        help="search stage: score MSV and Viterbi through the prefilter "
        "entry points (both exact, so the hits are the same)",
    )
    sweep.add_argument(
        "--bucketed",
        action="store_true",
        help="length-bucketed staging for ragged databases "
        "(msv/search stages)",
    )
    sweep.add_argument(
        "--checkpoint", default=None, metavar="DIR",
        help="resumable sweep (msv or search stage) — per-(profile, "
        "shard) results persist atomically under DIR; rerun skips "
        "completed chunks",
    )
    sweep.add_argument(
        "--checkpoint-shard", type=int, default=4096, metavar="N",
        help="sequences per checkpoint shard (default 4096)",
    )
    sweep.add_argument(
        "--stream",
        type=int,
        default=0,
        metavar="N",
        help="stream the FASTA in batches of N records: one database "
        "pass scans every profile per batch (bounded host memory)",
    )
    _add_common(sweep)
    sweep.set_defaults(fn=cmd_sweep)

    aln = sub.add_parser(
        "align", help="Viterbi-align every FASTA sequence to one profile"
    )
    aln.add_argument("--hmm", required=True, help="HMMER3 .hmm profile")
    aln.add_argument("--fasta", required=True, help="protein FASTA")
    aln.add_argument(
        "--format", default="tsv", choices=["tsv", "json", "stockholm"],
        help="tsv: hmmsearch-style blocks; stockholm: one MSA over all "
        "domains (the hmmalign/hmmsearch -A product)",
    )
    aln.add_argument("--out", default=None)
    aln.add_argument(
        "--loader", default="auto", choices=["auto", "native", "python"]
    )
    aln.add_argument(
        "--stream",
        type=int,
        default=0,
        metavar="N",
        help="stream the FASTA in batches of N records (bounded host "
        "memory)",
    )
    aln.set_defaults(fn=cmd_align)

    inf = sub.add_parser(
        "info", help="profile summary: NAME/LENG/STATS per .hmm (hmmstat-shaped)"
    )
    inf.add_argument("--hmm", default=None, help="one HMMER3 .hmm profile")
    inf.add_argument("--hmm-dir", default=None, help="a profile directory")
    inf.add_argument(
        "--hmm-db", default=None, metavar="FILE",
        help="a concatenated //-separated .hmm database",
    )
    inf.add_argument(
        "--consensus", action="store_true",
        help="also emit the model consensus string per profile",
    )
    inf.add_argument("--format", default="tsv", choices=["tsv", "json"])
    inf.add_argument("--out", default=None)
    inf.add_argument(
        "--loader", default="auto", choices=["auto", "native", "python"]
    )
    inf.set_defaults(fn=cmd_info)

    bld = sub.add_parser(
        "build", help="build + calibrate a profile from an MSA (hmmbuild-shaped)"
    )
    bld.add_argument("--msa", required=True,
                     help="Stockholm (RF-annotated) or aligned FASTA")
    bld.add_argument("--out", required=True, help="output .hmm path")
    bld.add_argument("--name", default=None,
                     help="profile NAME (default: MSA file stem)")
    bld.add_argument("--seed", type=int, default=0,
                     help="calibration simulation seed")
    bld.add_argument(
        "--weighting", default="pb", choices=["pb", "none"],
        help="sequence weighting: Henikoff position-based (H3 default) "
        "or uniform",
    )
    bld.set_defaults(fn=cmd_build)

    emt = sub.add_parser(
        "emit", help="sample sequences from a profile (hmmemit-shaped)"
    )
    emt.add_argument("--hmm", required=True, help="HMMER3 .hmm profile")
    emt.add_argument("--count", type=int, default=10)
    emt.add_argument("--seed", type=int, default=None)
    emt.add_argument(
        "--consensus", action="store_true",
        help="emit the consensus sequence instead of stochastic samples",
    )
    emt.add_argument("--out", default=None, help="write FASTA to a file")
    emt.add_argument("--width", type=int, default=70)
    emt.set_defaults(fn=cmd_emit)

    gen = sub.add_parser("generate", help="generate a random protein FASTA corpus")
    gen.add_argument("--out", default="random_FASTA.fsa")
    gen.add_argument("--count", type=int, default=3)
    gen.add_argument("--length", type=int, default=3500)
    gen.add_argument("--seed", type=int, default=None)
    gen.add_argument("--width", type=int, default=70)
    gen.set_defaults(fn=cmd_generate)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    from .runtime.cache import enable_compile_cache

    enable_compile_cache()
    try:
        return args.fn(args)
    except (FileNotFoundError, IsADirectoryError) as e:
        logger.error("%s", e)
        return 2
    except ValueError as e:  # HMMParseError / FastaParseError / bad inputs
        logger.error("%s", e)
        return 2
