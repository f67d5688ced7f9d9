#!/usr/bin/env python
"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: GCUPS scanning the reference's flagship workload — the
1400-state profile (algorithms/benchmark_MSV_1400.cpp) against 3500-aa
random sequences — batched, database staged on device (the reference
sweep shape: one FASTA x many profiles). The 24-profile sweep
(algorithms/benchmark_MSV.cpp equivalent), the M=2405 headline, the
Viterbi/Forward stages, the cascade, the posterior decode and the
streamed search run by default (--no-sweep / --no-m2405 / --no-stages /
--no-cascade / --no-stream to skip); ``--e2e`` adds cold end-to-end
(host encode + upload + scan) numbers. A failed row is recorded in the
JSON ``errors`` field and makes the exit code nonzero.

vs_baseline uses BASELINE.md's derived anchor (the reference publishes no
numbers): 1 GCUPS == one 14.7 ms reference benchmark pass.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from hmm_fasta_viterbi import MSVProfile, parse_hmm  # noqa: E402
from hmm_fasta_viterbi.bench.harness import (  # noqa: E402
    BenchResult,
    bench_profile,
    bench_staged,
    emit_json_line,
    random_tokens,
)
from hmm_fasta_viterbi.pipeline import (  # noqa: E402
    B_BUCKET,
    MSVScanner,
    _round_up,
)
from hmm_fasta_viterbi.runtime.cache import enable_compile_cache  # noqa: E402


def stage_random_device(scanner: MSVScanner, batch: int, seq_len: int):
    """Uniform random tokens generated on device (the reference
    generator's distribution, FASTA_files/random_FASTA_generator.py),
    staged without any host->device transfer."""
    import jax
    import jax.numpy as jnp

    b_pad = _round_up(batch, B_BUCKET)
    l_pad = _round_up(seq_len, scanner.l_chunk)
    tok = jax.random.randint(
        jax.random.PRNGKey(0), (b_pad, l_pad), 0, 20, dtype=jnp.int32
    ).astype(jnp.int8)
    lengths = np.zeros(b_pad, dtype=np.int32)
    lengths[:batch] = seq_len
    return scanner.stage_device(tok, lengths, num_sequences=batch)


def _substage(scanner: MSVScanner, staged, tokens, lengths, sb: int):
    """Stage the first sb sequences, reusing device data when possible."""
    if tokens is not None:
        return scanner.stage(tokens[:sb], lengths[:sb])
    sb_pad = _round_up(sb, B_BUCKET)
    return scanner.stage_device(
        staged.tokens_i8[:sb_pad],
        np.asarray(staged.lengths)[:sb_pad],
        num_sequences=min(sb, staged.num_sequences),
    )


class _P7StageScanner:
    """Adapter: bench_staged(scanner.scan) -> MSVScanner.scan_p7(stage)."""

    def __init__(self, scanner: MSVScanner, stage: str):
        self._scanner = scanner
        self._stage = stage

    def scan(self, profile, staged):
        return self._scanner.scan_p7(profile, staged, stage=self._stage)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--msv-impl", default="auto", choices=["auto", "cuda", "xla"]
    )
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--seq-len", type=int, default=3500)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true", help="small batch smoke run")
    ap.add_argument(
        "--no-sweep", dest="sweep", action="store_false", default=True,
        help="skip the 24-profile sweep (benchmark_MSV.cpp equivalent)",
    )
    ap.add_argument("--e2e", action="store_true", help="also time cold end-to-end scans")
    ap.add_argument(
        "--no-stages", dest="stages", action="store_false", default=True,
        help="skip the Viterbi/Forward stage kernel timings (batch/8)",
    )
    ap.add_argument(
        "--no-m2405", dest="m2405", action="store_false", default=True,
        help="skip the M=2405 headline timing",
    )
    ap.add_argument(
        "--no-cascade", dest="cascade", action="store_false", default=True,
        help="skip the end-to-end search-cascade timing",
    )
    ap.add_argument(
        "--no-oracle", dest="oracle", action="store_false", default=True,
        help="skip the NumPy sequential oracle context row "
        "(Algorithm_selector::seq, benchmark_helper.hpp:6; ~1 s)",
    )
    ap.add_argument(
        "--no-stream", dest="stream_search", action="store_false",
        default=True,
        help="skip the end-to-end streamed search benchmark "
        "(search --stream over a generated corpus, native reader)",
    )
    ap.add_argument(
        "--stream-seqs", type=int, default=16384,
        help="streamed-search corpus size in sequences (x --seq-len "
        "residues each; default 16384 x 3500 = 57 Mres)",
    )
    ap.add_argument(
        "--platform", default=None, choices=["cpu"],
        help="force the jax platform (a CPU smoke run)",
    )
    args = ap.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    if args.quick:
        args.batch = min(args.batch, 128)
        args.reps = 2

    enable_compile_cache()
    scanner = MSVScanner(msv_impl=args.msv_impl)
    impl = scanner.msv_impl
    print(f"# msv_impl={impl} batch={args.batch} L={args.seq_len}", file=sys.stderr)

    profile_dir = REPO / "data" / "profile_HMMs"
    if not args.e2e:
        # generate the random corpus on device: no host upload in set-up
        staged = stage_random_device(scanner, args.batch, args.seq_len)
        tokens = lengths = None
    else:
        tokens, lengths = random_tokens(args.batch, args.seq_len, seed=0)
        staged = scanner.stage(tokens, lengths)

    headline_profile = MSVProfile.from_profile(parse_hmm(profile_dir / "1400.hmm"))
    primary = bench_staged(
        f"headline_1400_{impl}", scanner, headline_profile, staged, args.reps
    )
    print(f"# headline: {primary.gcups:.2f} GCUPS ({primary.seconds*1e3:.1f} ms)", file=sys.stderr)

    extras: list[BenchResult] = []
    errors: list[str] = []

    def _extra(fn):
        # a failed row must not cost the others their numbers: it is
        # recorded in the JSON 'errors' field and fails the exit code
        try:
            fn()
        except Exception as e:  # pragma: no cover - defensive
            msg = f"{getattr(fn, '__name__', 'extra')}: {type(e).__name__}: {e}"
            errors.append(msg)
            print(f"# extra failed: {msg}", file=sys.stderr)

    def run_sweep():
        import time as _time

        # bounded batch: the sweep covers 24 profiles, so a 4096-deep
        # database already amortizes dispatch while keeping cold compile time
        # + run time modest
        sb = min(args.batch, 8192)
        sweep_staged = _substage(scanner, staged, tokens, lengths, sb)
        profiles = [
            MSVProfile.from_profile(parse_hmm(path))
            for path in sorted(profile_dir.glob("*.hmm"), key=lambda p: int(p.stem))
        ]
        scanner.scan_many(profiles, sweep_staged)  # warmup / compile per M-bucket
        s_reps = []
        for _ in range(max(args.reps, 2)):
            t0 = _time.perf_counter()
            scanner.scan_many(profiles, sweep_staged)
            s_reps.append(_time.perf_counter() - t0)
        best = min(s_reps)
        sweep_cells = sum(
            int(np.asarray(sweep_staged.lengths)[: sweep_staged.num_sequences].astype(np.int64).sum())
            * (p.model_length - 1)
            for p in profiles
        )
        extras.append(
            BenchResult(
                name=f"sweep24_{impl}",
                gcups=sweep_cells / best / 1e9,
                seconds=best,
                cells=sweep_cells,
                batch=sweep_staged.num_sequences,
                seq_len=args.seq_len,
                model_length=0,
                repetitions=max(args.reps, 2),
                rep_seconds=s_reps,
            )
        )
        print(
            f"# sweep24: {sweep_cells/best/1e9:.2f} GCUPS over "
            f"{sweep_cells/1e9:.1f} GCells in {best*1e3:.0f} ms",
            file=sys.stderr,
        )
        # per-profile rows (reference prints a best time PER profile plus
        # the sum — benchmark_MSV.cpp:18-23,32-41); these make cross-round
        # per-profile regressions attributable (VERDICT r4 item 5)
        for prof in profiles:
            r = bench_staged(
                f"sweep_p{prof.model_length - 1}_{impl}",
                scanner, prof, sweep_staged, max(2, min(args.reps, 3)),
            )
            extras.append(r)
        per_rows = [e for e in extras if e.name.startswith("sweep_p")]
        print(
            "# sweep24 per-profile: "
            + " ".join(
                f"{e.model_length - 1}:{e.seconds * 1e3:.0f}ms"
                for e in per_rows
            )
            + f" sum={sum(e.seconds for e in per_rows) * 1e3:.0f}ms",
            file=sys.stderr,
        )

    if args.sweep:
        _extra(run_sweep)

    def run_m2405():
        # BASELINE.md names GCUPS at M=1400 AND M=2405 as the per-device
        # targets; time the largest profile on a half batch
        p2405 = MSVProfile.from_profile(parse_hmm(profile_dir / "2405.hmm"))
        hb = max(128, args.batch // 2)
        h_staged = _substage(scanner, staged, tokens, lengths, hb)
        r = bench_staged(
            f"headline_2405_{impl}", scanner, p2405, h_staged, args.reps
        )
        extras.append(r)
        print(
            f"# M2405: {r.gcups:.2f} GCUPS ({r.seconds*1e3:.1f} ms, batch {hb})",
            file=sys.stderr,
        )

    if args.m2405:
        _extra(run_m2405)

    def run_stages():
        from hmm_fasta_viterbi.models.p7 import P7Profile

        p7 = P7Profile.from_profile(parse_hmm(profile_dir / "1400.hmm"))
        sb = max(128, args.batch // 4)
        s_staged = _substage(scanner, staged, tokens, lengths, sb)
        for nm in ("viterbi", "forward"):
            r = bench_staged(
                f"{nm}_1400_{impl}",
                _P7StageScanner(scanner, nm),
                p7,
                s_staged,
                args.reps,
            )
            extras.append(r)
            print(
                f"# {nm}: {r.gcups:.2f} GCUPS ({r.seconds*1e3:.1f} ms, batch {sb})",
                file=sys.stderr,
            )

    if args.stages:
        _extra(run_stages)

    def run_cascade():
        # end-to-end hmmsearch-style cascade over a host-staged batch
        # (SearchPipeline needs host tokens for survivor rescoring);
        # GCUPS denominates in MSV cells — the work a plain scan does
        import time as _time

        from hmm_fasta_viterbi.pipeline import SearchPipeline

        cb = min(args.batch, 4096)
        c_tokens, c_lengths = (
            (tokens[:cb], lengths[:cb])
            if tokens is not None
            else random_tokens(cb, args.seq_len, seed=0)
        )
        c_staged = scanner.stage(c_tokens, c_lengths)
        hmm = parse_hmm(profile_dir / "1400.hmm")
        cells = int(c_lengths.astype(np.int64).sum()) * (
            headline_profile.model_length - 1
        )
        for label, pipe in (("cascade_1400", SearchPipeline(scanner)),):
            pipe.search(hmm, c_staged, c_tokens, c_lengths)  # warmup
            c_reps = []
            for _ in range(max(args.reps, 2)):
                t0 = _time.perf_counter()
                pipe.search(hmm, c_staged, c_tokens, c_lengths)
                c_reps.append(_time.perf_counter() - t0)
            best = min(c_reps)
            extras.append(
                BenchResult(
                    name=f"{label}_{impl}",
                    gcups=cells / best / 1e9,
                    seconds=best,
                    cells=cells,
                    batch=cb,
                    seq_len=args.seq_len,
                    model_length=headline_profile.model_length,
                    repetitions=max(args.reps, 2),
                    rep_seconds=c_reps,
                )
            )
            print(
                f"# {label}: {cells/best/1e9:.2f} GCUPS ({best*1e3:.1f} ms, "
                f"batch {cb})",
                file=sys.stderr,
            )

    if args.cascade:
        _extra(run_cascade)

    def run_posterior():
        # batched forward-backward domain decode (the --domains path):
        # 2 DP passes per cell, reported as decode cells/s
        import time as _time

        from hmm_fasta_viterbi.models.p7 import P7Profile
        from hmm_fasta_viterbi.ops.p7_scan import (
            posterior_coverage_batch_xla,
        )

        p7 = P7Profile.from_profile(parse_hmm(profile_dir / "1400.hmm"))
        pb, pl_len = 256, 1024
        p_tokens, p_lengths = random_tokens(pb, pl_len, seed=2)
        posterior_coverage_batch_xla(p7, p_tokens, p_lengths)  # warm
        p_reps = []
        for _ in range(max(args.reps, 2)):
            t0 = _time.perf_counter()
            posterior_coverage_batch_xla(p7, p_tokens, p_lengths)
            p_reps.append(_time.perf_counter() - t0)
        best = min(p_reps)
        cells = pb * pl_len * (p7.model_length - 1)
        extras.append(
            BenchResult(
                name="posterior_1400_xla",
                gcups=cells / best / 1e9,
                seconds=best,
                cells=cells,
                batch=pb,
                seq_len=pl_len,
                model_length=p7.model_length,
                repetitions=max(args.reps, 2),
                rep_seconds=p_reps,
            )
        )
        print(
            f"# posterior: {cells/best/1e9:.2f} GCUPS decode "
            f"({best*1e3:.1f} ms, batch {pb} x L {pl_len})",
            file=sys.stderr,
        )

    if args.stages:
        _extra(run_posterior)

    def run_stream_search():
        # the end-to-end streamed path, measured — parse (native
        # reader, background prefetch thread) + encode + stage + full
        # cascade, over a generated on-disk corpus. Proves the
        # README streaming claim (parse overlaps device work) with a
        # number instead of a microbenchmark juxtaposition. GCUPS
        # denominates in MSV cells like the cascade rows.
        import tempfile
        import time as _time
        import types

        from hmm_fasta_viterbi.cli import _stream_search
        from hmm_fasta_viterbi.io.alphabet import AMINO_ACIDS
        from hmm_fasta_viterbi.pipeline import SearchPipeline
        from hmm_fasta_viterbi.runtime.profiling import SectionTimer

        n_seqs = max(4, args.stream_seqs if not args.quick else 64)
        chunk = max(1, min(4096, n_seqs // 4))  # >=4 stream batches
        rng = np.random.default_rng(3)
        letters = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)
        hmm = parse_hmm(profile_dir / "1400.hmm")
        with tempfile.NamedTemporaryFile(
            "wb", suffix=".fsa", delete=False
        ) as fh:
            corpus_path = fh.name
            wrap = 70
            for i in range(n_seqs):
                fh.write(f">s{i}\n".encode())
                row = letters[rng.integers(0, 20, args.seq_len)].tobytes()
                for off in range(0, len(row), wrap):
                    fh.write(row[off : off + wrap] + b"\n")
        try:
            s_args = types.SimpleNamespace(
                fasta=corpus_path, stream=chunk, loader="auto"
            )
            pipe = SearchPipeline(scanner)
            reps = max(args.reps, 2)
            # untimed warm pass: the cascade's stages and the
            # data-dependent survivor shapes all compile on first touch;
            # without it the reps never reach steady state
            _stream_search(
                s_args, scanner, pipe, [hmm], keep_tokens=False,
                timer=SectionTimer(),
            )
            best, best_timer, cells = None, None, 0
            s_reps = []
            for _ in range(reps):
                timer = SectionTimer()
                t0 = _time.perf_counter()
                _out, n_total, cells = _stream_search(
                    s_args, scanner, pipe, [hmm], keep_tokens=False,
                    timer=timer,
                )
                dt = _time.perf_counter() - t0
                s_reps.append(dt)
                if best is None or dt < best:
                    best, best_timer = dt, timer
            assert n_total == n_seqs, f"stream lost records: {n_total}"
            host_wait = best_timer.sections.get("prefetch_wait", 0.0)
            extras.append(
                BenchResult(
                    name=f"stream_search_1400_{impl}",
                    gcups=cells / best / 1e9,
                    seconds=best,
                    cells=cells,
                    batch=chunk,
                    seq_len=args.seq_len,
                    model_length=hmm.model_length,
                    repetitions=reps,
                    rep_seconds=s_reps,
                )
            )
            print(
                f"# stream_search: {cells/best/1e9:.2f} GCUPS e2e over "
                f"{n_seqs} seqs ({best:.2f} s; host parse not hidden by "
                f"device work: {host_wait/best:.0%}; "
                f"phases {best_timer.report()})",
                file=sys.stderr,
            )
        finally:
            os.unlink(corpus_path)

    if args.stream_search:
        _extra(run_stream_search)

    def run_oracle():
        # sequential NumPy oracle throughput for context — the bench
        # path the reference's Algorithm_selector::seq would take
        # (algorithms/benchmark_helper.hpp:6)
        import time as _time

        from hmm_fasta_viterbi.ops.reference import msv_oracle_batch

        o_tokens, o_lengths = random_tokens(2, args.seq_len, seed=0)
        t0 = _time.perf_counter()
        msv_oracle_batch(headline_profile, o_tokens, o_lengths)
        dt = _time.perf_counter() - t0
        cells = int(o_lengths.astype(np.int64).sum()) * (
            headline_profile.model_length - 1
        )
        extras.append(
            BenchResult(
                name="oracle_msv_numpy",
                gcups=cells / dt / 1e9,
                seconds=dt,
                cells=cells,
                batch=2,
                seq_len=args.seq_len,
                model_length=headline_profile.model_length,
                repetitions=1,
            )
        )
        print(f"# oracle: {cells/dt/1e9:.3f} GCUPS ({dt*1e3:.0f} ms)", file=sys.stderr)

    if args.oracle:
        _extra(run_oracle)

    def _e2e_scan():
        # host encode + upload + scan, through the user's entry points
        return lambda prof, tok, ln: scanner.scan(prof, scanner.stage(tok, ln))

    def run_ref_b3():
        # the literal reference workload (benchmark_MSV_1400.cpp:8-13:
        # 1400.hmm x 3 sequences x 3500 aa), timed end-to-end including
        # host encode + upload — always recorded so every BENCH artifact
        # carries the reference-pass number
        ref_tokens, ref_lengths = random_tokens(3, 3500, seed=0)
        r = bench_profile(
            f"ref_1400_b3_{impl}", headline_profile, _e2e_scan(),
            ref_tokens, ref_lengths, args.reps,
        )
        extras.append(r)
        print(
            f"# ref_b3: {r.gcups:.2f} GCUPS ({r.seconds*1e3:.2f} ms; the "
            "reference pass shape)",
            file=sys.stderr,
        )

    _extra(run_ref_b3)

    def run_e2e():
        extras.append(
            bench_profile(
                f"e2e_1400_{impl}", headline_profile, _e2e_scan(), tokens, lengths, args.reps
            )
        )

    if args.e2e:
        _extra(run_e2e)

    scores = np.asarray(scanner.scan(headline_profile, staged))
    assert np.all(np.isfinite(scores)), "benchmark scan produced non-finite scores"

    # full per-rep detail goes to a file (the driver archives only the
    # tail of stdout; BENCH_r04's primary row was truncated out by the
    # old all-in-one line) — the printed line stays compact
    print(emit_json_line(primary, extras, errors=errors,
                         detail_path=str(REPO / "bench_detail.json")))
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
