#!/usr/bin/env python
"""GPU check: the scan and search path at full width on one CUDA card.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the mesh phases only

One process drives everything (a second JAX process would not get the
card's memory); the CLI is called in-process through ``cli.main``. Each
phase prints its own lines and any failure exits nonzero. The last line
of standard output is one JSON object naming the device.

0. device: JAX's first device must be a GPU (there is no CPU fallback);
   prints its kind, the JAX version and nvidia-smi's name, power.limit.
1. build: the CUDA MSV library from native/msv_cuda.cu (set-up time).
2. MSV parity: profiles 100, 1400 and 2405 against 16384 x 3500 seeded
   random residues — the kernel (MSVScanner.scan) against XLA's
   xla_scan.msv_scan_batch over every row and msv_oracle on 32 rows.
3. sweep: ``sweep`` over all 24 profiles at 2048 x 3500, sampled rows of
   every profile against msv_oracle.
4. streamed search: ``scan --stream 8192 --stage search --domains`` on a
   FASTA of the 16384 random sequences plus 64 homologs emitted from
   1400.hmm; every homolog must be a hit, sampled MSV / Viterbi /
   Forward scores against the oracles.
5. end to end: ``scan --stream 8192`` at M=1400 and M=2405 with the
   kernel and with XLA on the same FASTA, identical rows, warm wall
   time of each.

``--four-cards`` runs, on four cards, ``scan`` and ``scan --stage
search`` with ``--mesh db=4`` and the MSV wavefront with ``--mesh
db=2,sp=2``, each against the single-device result of the same process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
DATA = REPO / ".smoke_data"  # listed in .gitignore; removed at the end
PROFILES = REPO / "data" / "profile_HMMs"

SEED = 20240611
NUM_SEQS, SEQ_LEN = 16384, 3500
SWEEP_SEQS = 2048
HOMOLOGS = 64
STREAM = 8192
MSV_TOL, VIT_TOL, FWD_TOL = 1e-4, 1e-4, 2e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def run_cli(argv: list[str]) -> tuple[object, float]:
    """``cli.main(argv)`` in this process with --format json; returns the
    parsed rows and the wall seconds. A nonzero exit fails the phase."""
    from hmm_fasta_viterbi.cli import main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv + ["--format", "json"])
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}")
    return json.loads(out.getvalue()), dt


def write_fasta(path: pathlib.Path, names: list[str], rows: list) -> None:
    from hmm_fasta_viterbi.io.alphabet import AMINO_ACIDS

    import numpy as np

    letters = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        for name, row in zip(names, rows):
            fh.write(b">" + name.encode() + b"\n")
            fh.write(letters[row].tobytes() + b"\n")


def random_corpus():
    import numpy as np

    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, 20, size=(NUM_SEQS, SEQ_LEN), dtype=np.int8)
    lengths = np.full(NUM_SEQS, SEQ_LEN, dtype=np.int32)
    return tokens, lengths


def phase_device(cards: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"no GPU: JAX's first device is {devices[0].platform!r}; "
            "this check runs on a CUDA card only", file=sys.stderr,
        )
        raise SystemExit(1)
    check(len(devices) >= cards, f"need {cards} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    say(f"[0 device] {devices[0].device_kind} x{len(devices)}, jax {jax.__version__}")
    for line in smi.stdout.strip().splitlines():
        say(line.strip())
    return devices


def phase_build():
    from hmm_fasta_viterbi.ops import msv_cuda

    t0 = time.perf_counter()
    msv_cuda.register()
    built = msv_cuda.build_seconds
    say(
        f"[1 build] {msv_cuda.library_path().name}: "
        + (f"nvcc {built:.1f} s" if built is not None else "prebuilt")
        + f", set-up {time.perf_counter() - t0:.1f} s"
    )
    spills = [ln for ln in msv_cuda.ptxas_report().splitlines()
              if "spill" in ln and not ln.startswith("0 bytes stack")]
    check(not spills, f"register spills: {spills}")


def phase_msv_parity(tokens, lengths):
    import jax
    import numpy as np

    from hmm_fasta_viterbi import MSVProfile, msv_oracle, parse_hmm
    from hmm_fasta_viterbi.ops import msv_cuda
    from hmm_fasta_viterbi.ops.xla_scan import msv_scan_batch
    from hmm_fasta_viterbi.pipeline import MSVScanner

    scanner = MSVScanner()
    check(scanner.msv_impl == "cuda", f"auto picked {scanner.msv_impl!r} on a GPU")
    xla_scanner = MSVScanner(msv_impl="xla")
    staged = scanner.stage(tokens, lengths)
    rows = np.random.default_rng(SEED + 1).choice(NUM_SEQS, 32, replace=False)
    for stem in ("100", "1400", "2405"):
        p = MSVProfile.from_profile(parse_hmm(PROFILES / f"{stem}.hmm"))
        q = msv_cuda.states_per_lane(p.num_states)
        ops = (
            jax.numpy.asarray(msv_cuda.pack_table(p.scores_real, q)[None]),
            staged.tokens_i8, staged.lengths, staged.tr_rows,
            jax.numpy.asarray(np.array([[p.tr_B_Mk, p.tr_E_C, p.tr_E_J]], np.float32)),
        )
        t0 = time.perf_counter()
        compiled = jax.jit(msv_cuda.msv_packed).lower(*ops).compile()
        compile_s = time.perf_counter() - t0
        got = np.asarray(scanner.scan(p, staged))
        t0 = time.perf_counter()
        jax.block_until_ready(scanner.scan(p, staged))
        warm = time.perf_counter() - t0

        xla_args = (
            jax.numpy.asarray(p.scores_real), np.float32(p.tr_B_Mk),
            np.float32(p.tr_E_C), np.float32(p.tr_E_J), staged.tokens_i8,
            staged.lengths, staged.tr_rows[0], staged.tr_rows[1],
        )
        t0 = time.perf_counter()
        msv_scan_batch.lower(*xla_args).compile()
        xla_compile_s = time.perf_counter() - t0
        want = np.asarray(msv_scan_batch(*xla_args))[:NUM_SEQS]
        t0 = time.perf_counter()
        jax.block_until_ready(msv_scan_batch(*xla_args))
        xla_warm = time.perf_counter() - t0
        xla_scanner.scan(p, staged).block_until_ready()
        t0 = time.perf_counter()
        xla_scanner.scan(p, staged).block_until_ready()
        xla_user_warm = time.perf_counter() - t0

        err_xla = float(np.max(np.abs(got - want)))
        oracle = np.array([msv_oracle(p, tokens[r, : lengths[r]]) for r in rows])
        err_oracle = float(np.max(np.abs(got[rows] - oracle)))
        cells = float(lengths.astype(np.int64).sum()) * p.num_states
        say(
            f"[2 msv M={p.num_states} q={q}] max|kernel-xla| {err_xla} over "
            f"{NUM_SEQS} rows, max|kernel-oracle| {err_oracle} over 32 rows; "
            f"compile {compile_s:.3f} s (xla {xla_compile_s:.3f} s); warm "
            f"kernel {warm:.4f} s ({cells / warm / 1e9:.1f} GCUPS), xla "
            f"msv_scan_batch {xla_warm:.4f} s ({cells / xla_warm / 1e9:.1f} "
            f"GCUPS), xla scanner {xla_user_warm:.4f} s"
        )
        say(f"    memory_analysis: {compiled.memory_analysis()}")
        check(np.isfinite(got).all(), f"M={p.num_states}: non-finite scores")
        check(err_xla <= MSV_TOL, f"M={p.num_states}: kernel vs xla {err_xla}")
        check(err_oracle <= MSV_TOL, f"M={p.num_states}: kernel vs oracle {err_oracle}")


def phase_sweep(tokens, lengths):
    import numpy as np

    from hmm_fasta_viterbi import MSVProfile, msv_oracle, parse_hmm

    fasta = DATA / "sweep.fsa"
    names = [f"s{i}" for i in range(SWEEP_SEQS)]
    write_fasta(fasta, names, tokens[:SWEEP_SEQS])
    rows, dt = run_cli(["sweep", "--hmm-dir", str(PROFILES), "--fasta", str(fasta)])
    paths = sorted(PROFILES.glob("*.hmm"), key=lambda p: int(p.stem))
    check(len(rows) == len(paths) * SWEEP_SEQS, f"sweep returned {len(rows)} rows")
    by_key = {(r["profile"], r["target"]): r["score_nats"] for r in rows}
    sample = np.random.default_rng(SEED + 2).choice(SWEEP_SEQS, 2, replace=False)
    worst = 0.0
    for path in paths:
        p = MSVProfile.from_profile(parse_hmm(path))
        for i in sample:
            got = by_key[(p.name, names[i])]
            want = float(msv_oracle(p, tokens[i, : lengths[i]]))
            worst = max(worst, abs(got - want))
    cells = SWEEP_SEQS * SEQ_LEN * sum(
        MSVProfile.from_profile(parse_hmm(p)).num_states for p in paths
    )
    say(
        f"[3 sweep] {len(paths)} profiles x {SWEEP_SEQS} x {SEQ_LEN}: "
        f"{dt:.2f} s cold through the CLI ({cells / dt / 1e9:.1f} GCUPS); "
        f"max|score_nats - oracle| {worst} over {2 * len(paths)} rows "
        "(score_nats is rounded to 1e-4)"
    )
    check(worst <= MSV_TOL, f"sweep vs oracle {worst}")


def search_corpus(tokens):
    """The random corpus with 64 homologs of 1400.hmm at seeded slots."""
    import numpy as np

    from hmm_fasta_viterbi import parse_hmm
    from hmm_fasta_viterbi.models.sample import sample_sequences

    hmm = parse_hmm(PROFILES / "1400.hmm", star_as_zero_prob=True)
    homologs = sample_sequences(hmm, HOMOLOGS, seed=SEED + 3)
    slots = set(
        np.random.default_rng(SEED + 4)
        .choice(NUM_SEQS + HOMOLOGS, HOMOLOGS, replace=False)
        .tolist()
    )
    names, rows, planted = [], [], {}
    it_rand, it_hom = iter(range(NUM_SEQS)), iter(range(HOMOLOGS))
    for k in range(NUM_SEQS + HOMOLOGS):
        if k in slots:
            h = next(it_hom)
            names.append(f"homolog{h}")
            rows.append(homologs[h])
            planted[names[-1]] = homologs[h]
        else:
            r = next(it_rand)
            names.append(f"random{r}")
            rows.append(tokens[r])
    fasta = DATA / "search.fsa"
    write_fasta(fasta, names, rows)
    return fasta, planted


def phase_search(tokens, lengths, fasta, planted):
    import numpy as np

    from hmm_fasta_viterbi import MSVProfile, msv_oracle, parse_hmm
    from hmm_fasta_viterbi.models import stats
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.reference import forward_oracle, viterbi_oracle
    from hmm_fasta_viterbi.pipeline import MSVScanner

    hmm_path = PROFILES / "1400.hmm"
    rows, dt = run_cli([
        "scan", "--stream", str(STREAM), "--stage", "search", "--domains",
        "--hmm", str(hmm_path), "--fasta", str(fasta),
    ])
    by_target = {r["target"]: r for r in rows}
    hits = {t for t, r in by_target.items() if r["hit"]}
    missed = sorted(set(planted) - hits)
    say(
        f"[4 search] {NUM_SEQS + HOMOLOGS} seqs -> {len(rows)} past MSV -> "
        f"{len(hits)} hits in {dt:.2f} s cold through the CLI; "
        f"{len(planted) - len(missed)}/{len(planted)} homologs hit"
    )
    check(not missed, f"planted homologs not reported as hits: {missed[:8]}")
    check(
        all(by_target[t].get("ndom", 0) >= 1 for t in planted),
        "a homolog hit has no posterior envelope",
    )

    hmm = parse_hmm(hmm_path)
    msvp, p7 = MSVProfile.from_profile(hmm), P7Profile.from_profile(hmm)
    sample = sorted(planted)[:4]
    randoms = sorted(t for t in by_target if t.startswith("random"))[:4]
    msv_err = 0.0
    for t in sample + randoms:
        toks = planted[t] if t in planted else tokens[int(t[6:])]
        want = float(msv_oracle(msvp, np.asarray(toks, np.int32)))
        msv_err = max(msv_err, abs(by_target[t]["msv_bits"] * math.log(2) - want))
    # the hits' Viterbi / Forward scores on the device (the cascade's own
    # staged stage scan), tied to the p-values the search reported
    scanner = MSVScanner()
    width = max(len(planted[t]) for t in sample)
    batch = np.zeros((len(sample), width), np.int32)
    lens = np.array([len(planted[t]) for t in sample], np.int32)
    for k, t in enumerate(sample):
        batch[k, : lens[k]] = planted[t]
    staged = scanner.stage(batch, lens)
    errs = {}
    for stage, oracle, pfn, key in (
        ("viterbi", viterbi_oracle, stats.viterbi_pvalue, "viterbi_p"),
        ("forward", forward_oracle, stats.forward_pvalue, "forward_p"),
    ):
        got = np.asarray(scanner.scan_p7(p7, staged, stage=stage))
        want = np.array([oracle(p7, batch[k, : lens[k]]) for k in range(len(sample))])
        errs[stage] = float(np.max(np.abs(got - want)))
        for k, t in enumerate(sample):
            reported = by_target[t][key]
            check(
                math.isclose(float(pfn(np.float64(got[k]), hmm)), reported,
                             rel_tol=1e-2),
                f"{t}: {key} {reported} disagrees with the device score",
            )
    say(
        f"    max|msv - oracle| {msv_err} over {len(sample) + len(randoms)} "
        f"survivors (msv_bits is rounded to 1e-4); max|viterbi - oracle| "
        f"{errs['viterbi']}, max|forward - oracle| {errs['forward']} over "
        f"{len(sample)} hits"
    )
    check(msv_err <= MSV_TOL, f"search msv vs oracle {msv_err}")
    check(errs["viterbi"] <= VIT_TOL, f"viterbi vs oracle {errs['viterbi']}")
    check(errs["forward"] <= FWD_TOL, f"forward vs oracle {errs['forward']}")


def phase_end_to_end(fasta):
    for stem in ("1400", "2405"):
        base = ["scan", "--stream", str(STREAM), "--hmm",
                str(PROFILES / f"{stem}.hmm"), "--fasta", str(fasta)]
        results = {}
        for impl in ("cuda", "xla"):
            run_cli(base + ["--msv-impl", impl])  # compile
            results[impl] = run_cli(base + ["--msv-impl", impl])
        (rows_k, dt_k), (rows_x, dt_x) = results["cuda"], results["xla"]
        same = rows_k == rows_x
        say(
            f"[5 end to end] scan --stream {STREAM} M={stem} over "
            f"{NUM_SEQS + HOMOLOGS} seqs, warm: kernel {dt_k:.2f} s, xla "
            f"{dt_x:.2f} s; rows identical: {same}"
        )
        check(same, f"kernel and xla scans disagree end to end at M={stem}")


def phase_four_cards(tokens):
    import numpy as np

    fasta = DATA / "mesh.fsa"
    n = min(8192, len(tokens))
    names = [f"s{i}" for i in range(n)]
    write_fasta(fasta, names, tokens[:n])
    hmm = str(PROFILES / "1400.hmm")
    scan = ["scan", "--hmm", hmm, "--fasta", str(fasta)]
    one, t1 = run_cli(scan)
    four, t4 = run_cli(scan + ["--mesh", "db=4"])
    a = {r["target"]: r["score_nats"] for r in one}
    b = {r["target"]: r["score_nats"] for r in four}
    err = max(abs(a[t] - b[t]) for t in a) if a.keys() == b.keys() else math.inf
    say(f"[4c scan db=4] {n} x {SEQ_LEN} M=1400: max|4 cards - 1 card| {err} "
        f"(cold {t4:.2f} s vs {t1:.2f} s)")
    check(err == 0.0, f"db=4 scan differs from one card: {err}")

    # plant the consensus so the cascade's later stages have work
    from hmm_fasta_viterbi import parse_hmm

    h = parse_hmm(PROFILES / "1400.hmm")
    rows = list(tokens[:n])
    rows[7] = np.argmax(h.match_emissions[1:], axis=1).astype(np.int8)
    write_fasta(fasta, names, rows)
    search = ["scan", "--stage", "search", "--hmm", hmm, "--fasta", str(fasta)]
    one, _ = run_cli(search)
    four, _ = run_cli(search + ["--mesh", "db=4"])
    key = lambda r: (r["target"], r["hit"], r["msv_bits"])
    same = sorted(map(key, one)) == sorted(map(key, four))
    hits = sum(r["hit"] for r in four)
    say(f"[4c search db=4] {len(four)} past MSV, {hits} hits; rows identical "
        f"to one card: {same}")
    check(same and hits >= 1, "db=4 search differs from one card")

    sub = DATA / "wavefront.fsa"
    m = 256
    write_fasta(sub, names[:m], rows[:m])
    wf_scan = ["scan", "--hmm", hmm, "--fasta", str(sub)]
    one, _ = run_cli(wf_scan)
    wave, t = run_cli(wf_scan + ["--mesh", "db=2,sp=2"])
    a = {r["target"]: r["score_nats"] for r in one}
    b = {r["target"]: r["score_nats"] for r in wave}
    err = max(abs(a[k] - b[k]) for k in a) if a.keys() == b.keys() else math.inf
    say(f"[4c wavefront db=2,sp=2] {m} x {SEQ_LEN}: max|wavefront - 1 card| "
        f"{err} ({t:.2f} s)")
    check(err <= MSV_TOL, f"wavefront differs from one card: {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run the mesh phases on four cards instead of the one-card phases",
    )
    args = ap.parse_args()
    if not (REPO / "hmm_fasta_viterbi").is_dir():
        print("the hmm_fasta_viterbi package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    cards = 4 if args.four_cards else 1

    from hmm_fasta_viterbi.runtime.cache import enable_compile_cache

    enable_compile_cache()
    t_start = time.perf_counter()
    devices = phase_device(cards)
    phase_build()
    DATA.mkdir(exist_ok=True)
    try:
        tokens, lengths = random_corpus()
        if args.four_cards:
            phase_four_cards(tokens)
        else:
            phase_msv_parity(tokens, lengths)
            phase_sweep(tokens, lengths)
            fasta, planted = search_corpus(tokens)
            phase_search(tokens, lengths, fasta, planted)
            phase_end_to_end(fasta)
    finally:
        shutil.rmtree(DATA, ignore_errors=True)
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
