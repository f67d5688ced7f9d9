"""CLI + statistics tests."""

import json

import numpy as np
import pytest

from hmm_fasta_viterbi import parse_hmm
from hmm_fasta_viterbi.cli import main
from hmm_fasta_viterbi.models import stats


def test_gumbel_pvalue_properties():
    # monotone decreasing in score; calibrated point: P(mu) = 1 - exp(-1)
    mu, lam = -9.5678, 0.71755
    p_at_mu = stats.gumbel_pvalue(mu, mu, lam)
    assert p_at_mu == pytest.approx(1 - np.exp(-1))
    scores = np.array([-20.0, -10.0, 0.0, 10.0, 30.0])
    p = stats.gumbel_pvalue(scores, mu, lam)
    assert np.all(np.diff(p) < 0)
    assert np.all((p > 0) & (p <= 1))
    # extreme scores underflow gracefully, not to nan
    assert stats.gumbel_pvalue(1000.0, mu, lam) >= 0.0


def test_msv_pvalue_uses_profile_stats(profile_dir):
    hmm = parse_hmm(profile_dir / "100.hmm")
    p = stats.msv_pvalue(np.array([0.0]), hmm)
    want = stats.gumbel_pvalue(stats.nats_to_bits(0.0), -9.5678, 0.71755)
    assert p[0] == pytest.approx(want, rel=1e-6)


def test_exp_tail_pvalue():
    tau, lam = -3.4821, 0.71755
    assert stats.exp_tail_pvalue(tau, tau, lam) == pytest.approx(1.0)
    assert stats.exp_tail_pvalue(tau - 5, tau, lam) == 1.0  # clamped
    assert stats.exp_tail_pvalue(tau + 10, tau, lam) < 1e-3


def test_cli_scan_tsv(profile_dir, fasta_dir, capsys):
    rc = main(
        [
            "scan",
            "--hmm",
            str(profile_dir / "100.hmm"),
            "--fasta",
            str(fasta_dir / "fasta_like_example.fsa"),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if not l.startswith("#")]
    assert len(lines) == 4
    cols = lines[0].split("\t")
    assert cols[1] == "Pfam-B_229"
    float(cols[2]), float(cols[3])  # parse scores


def test_cli_scan_json_topk(profile_dir, fasta_dir, capsys):
    rc = main(
        [
            "scan",
            "--hmm",
            str(profile_dir / "100.hmm"),
            "--fasta",
            str(fasta_dir / "fasta_like_example.fsa"),
            "--format",
            "json",
            "--top",
            "2",
        ]
    )
    assert rc == 0
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 2
    assert rows[0]["score_nats"] >= rows[1]["score_nats"]


def test_cli_generate_and_scan_roundtrip(tmp_path, profile_dir, capsys):
    fasta = tmp_path / "gen.fsa"
    rc = main(["generate", "--out", str(fasta), "--count", "2", "--length", "100", "--seed", "7"])
    assert rc == 0
    capsys.readouterr()
    rc = main(["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta)])
    assert rc == 0
    out = capsys.readouterr().out
    assert len([l for l in out.splitlines() if not l.startswith("#")]) == 2


def test_cli_empty_db_errors(tmp_path, profile_dir):
    fasta = tmp_path / "bad.fsa"
    fasta.write_text(">only\nXXXX\n")  # rejected -> empty db
    rc = main(["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta)])
    assert rc == 1


def test_cli_sweep_search_cascade(tmp_path, profile_dir, fasta_dir, capsys):
    """hmmscan-shaped sweep: full cascade per profile, one staged DB."""
    import shutil

    hmm_dir = tmp_path / "profiles"
    hmm_dir.mkdir()
    for stem in ("100", "200"):
        shutil.copy(profile_dir / f"{stem}.hmm", hmm_dir)
    rc = main(
        [
            "sweep",
            "--stage", "search",
            "--fast",
            "--hmm-dir", str(hmm_dir),
            "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    # one header block per profile
    assert out.count("# target\tprofile\tmsv_bits") == 2


def test_pvalue_calibration_sanity(profile_dir):
    """End-to-end statistical sanity: MSV P-values of random sequences
    against a HMMER-calibrated profile must behave like (sub-)uniform
    tail probabilities — not systematically significant."""
    from hmm_fasta_viterbi import MSVProfile, parse_hmm
    from hmm_fasta_viterbi.ops.xla_scan import msv_xla

    hmm = parse_hmm(profile_dir / "100.hmm")
    profile = MSVProfile.from_profile(hmm)
    rng = np.random.default_rng(42)
    n, L = 256, 250
    tokens = rng.integers(0, 20, size=(n, L)).astype(np.int32)
    lengths = np.full(n, L, dtype=np.int32)
    scores = np.asarray(msv_xla(profile, tokens, lengths))
    pv = stats.msv_pvalue(scores, hmm)
    assert np.all((pv >= 0) & (pv <= 1))
    # random (null-model) sequences: significance must be rare
    assert (pv <= 0.02).mean() <= 0.15, pv.min()
    assert np.median(pv) > 0.1


def test_cli_sweep_json_out_is_valid_json(tmp_path, profile_dir, fasta_dir):
    """Multi-profile sweep with --format json --out must emit ONE valid
    JSON document, not concatenated arrays."""
    import json as _json
    import shutil

    hmm_dir = tmp_path / "profiles"
    hmm_dir.mkdir()
    for stem in ("100", "200"):
        shutil.copy(profile_dir / f"{stem}.hmm", hmm_dir)
    out = tmp_path / "results.json"
    rc = main(
        [
            "sweep",
            "--hmm-dir", str(hmm_dir),
            "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
            "--format", "json",
            "--out", str(out),
        ]
    )
    assert rc == 0
    rows = _json.loads(out.read_text())
    assert isinstance(rows, list)
    assert len({r["profile"] for r in rows}) == 2  # one entry set per profile


def test_cli_mesh_scan(profile_dir, fasta_dir, capsys):
    """--mesh shards the scan over the virtual 8-device CPU mesh through
    the CLI; scores must match the meshless run."""
    args = [
        "scan", "--hmm", str(profile_dir / "100.hmm"),
        "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
        "--format", "json",
    ]
    assert main(args + ["--mesh", "db=8", "--msv-impl", "xla"]) == 0
    mesh_rows = json.loads(capsys.readouterr().out)
    assert main(args + ["--msv-impl", "xla"]) == 0
    plain_rows = json.loads(capsys.readouterr().out)
    assert len(mesh_rows) == len(plain_rows) == 4
    by_target = {r["target"]: r["score_nats"] for r in plain_rows}
    for r in mesh_rows:
        assert r["score_nats"] == pytest.approx(by_target[r["target"]], abs=1e-4)
    # streaming composes with the db mesh: each batch stages sharded
    assert main(args + ["--mesh", "db=2", "--msv-impl", "xla",
                        "--stream", "2"]) == 0
    streamed = json.loads(capsys.readouterr().out)
    assert len(streamed) == 4
    for r in streamed:
        assert r["score_nats"] == pytest.approx(by_target[r["target"]], abs=1e-4)


def test_cli_sweep_checkpoint_resume(profile_dir, fasta_dir, tmp_path, capsys):
    """sweep --checkpoint persists per-(profile, shard) results; a rerun
    skips completed shards (mtimes unchanged) and reproduces the output."""
    import os
    import shutil

    hmm_dir = tmp_path / "hmms"
    hmm_dir.mkdir()
    for n in ("100", "200"):
        shutil.copy(profile_dir / f"{n}.hmm", hmm_dir / f"{n}.hmm")
    ckpt = tmp_path / "ckpt"
    args = [
        "sweep", "--hmm-dir", str(hmm_dir),
        "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
        "--msv-impl", "xla", "--format", "json",
        "--checkpoint", str(ckpt), "--checkpoint-shard", "2",
    ]
    assert main(args) == 0
    first = json.loads(capsys.readouterr().out)
    chunks = sorted(ckpt.glob("*.npz"))
    # 2 profiles x ceil(4/2) shards
    assert len(chunks) == 4
    mtimes = {p.name: os.stat(p).st_mtime_ns for p in chunks}

    assert main(args) == 0
    second = json.loads(capsys.readouterr().out)
    assert second == first
    for p in sorted(ckpt.glob("*.npz")):
        assert os.stat(p).st_mtime_ns == mtimes[p.name]  # not recomputed


def test_cli_mesh_sp_wavefront(profile_dir, fasta_dir, capsys):
    """--mesh db=2,sp=4 routes the scan through the sequence-block
    wavefront (residue blocks across devices); scores match the plain
    run."""
    args = [
        "scan", "--hmm", str(profile_dir / "100.hmm"),
        "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
        "--format", "json",
    ]
    assert main(args + ["--mesh", "db=2,sp=4", "--msv-impl", "xla"]) == 0
    sp_rows = json.loads(capsys.readouterr().out)
    assert main(args + ["--msv-impl", "xla"]) == 0
    plain_rows = json.loads(capsys.readouterr().out)
    by_target = {r["target"]: r["score_nats"] for r in plain_rows}
    assert len(sp_rows) == 4
    for r in sp_rows:
        assert r["score_nats"] == pytest.approx(by_target[r["target"]], abs=1e-4)


@pytest.mark.parametrize(
    "cmd,stage",
    [("scan", "viterbi"), ("scan", "forward"), ("scan", "search"),
     ("sweep", "search")],
)
def test_cli_mesh_sp_refuses_p7_stages(profile_dir, fasta_dir, caplog, cmd, stage):
    """--mesh sp>1 serves the MSV stage only: the Viterbi / Forward
    stages (and the cascade that needs them) are refused with an error
    naming the missing wavefront, not scored another way."""
    where = (["--hmm", str(profile_dir / "100.hmm")] if cmd == "scan"
             else ["--hmm-dir", str(profile_dir)])
    rc = main([cmd, *where, "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
               "--stage", stage, "--mesh", "db=2,sp=4"])
    assert rc == 2
    assert "wavefront" in caplog.text


def test_cli_mesh_sp_sweep(profile_dir, fasta_dir, capsys):
    """Round 3: sweep accepts --mesh sp>1 (wavefront per profile)."""
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        hmm_dir = pathlib.Path(td)
        for name in ("100.hmm", "200.hmm"):
            (hmm_dir / name).write_bytes(
                (profile_dir / name).read_bytes()
            )
        args = [
            "sweep", "--hmm-dir", str(hmm_dir),
            "--fasta", str(fasta_dir / "fasta_like_example.fsa"),
            "--format", "json",
        ]
        assert main(args + ["--mesh", "db=2,sp=4", "--msv-impl", "xla"]) == 0
        sp_rows = json.loads(capsys.readouterr().out)
        assert main(args + ["--msv-impl", "xla"]) == 0
        plain_rows = json.loads(capsys.readouterr().out)
    key = lambda r: (r["target"], r["profile"])
    by_key = {key(r): r["score_nats"] for r in plain_rows}
    assert len(sp_rows) == len(plain_rows) == 8
    for r in sp_rows:
        assert r["score_nats"] == pytest.approx(by_key[key(r)], abs=1e-4)


def test_cli_search_align(tmp_path, profile_dir, capsys):
    """--align reports per-domain Viterbi alignments for hits (round 3:
    host-side traceback, ops.traceback) in both JSON and text formats."""
    from conftest import consensus_tokens
    from hmm_fasta_viterbi.io.alphabet import decode_sequence

    hmm = __import__("hmm_fasta_viterbi").parse_hmm(
        profile_dir / "100.hmm"
    )
    rng = np.random.default_rng(5)
    fasta = tmp_path / "db.fsa"
    seqs = [
        decode_sequence(consensus_tokens(hmm, repeats=2, spacer=25)),
        decode_sequence(rng.integers(0, 20, size=150)),
    ]
    fasta.write_text("".join(f">seq{i}\n{s}\n" for i, s in enumerate(seqs)))
    args = [
        "scan", "--hmm", str(profile_dir / "100.hmm"),
        "--fasta", str(fasta), "--stage", "search",
        "--msv-impl", "xla", "--align",
    ]
    assert main(args + ["--format", "json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    hit = next(r for r in rows if r["hit"])
    alns = hit["alignments"]
    assert len(alns) == 2  # two consensus repeats -> two domains
    for a in alns:
        assert a["hmm_from"] >= 1 and a["hmm_to"] <= hmm.model_length - 1
        assert len(a["model"]) == len(a["match"]) == len(a["aseq"])
        # emitted residues reconstruct the sequence slice
        res = a["aseq"].replace("-", "").upper()
        assert len(res) == a["seq_to"] - a["seq_from"] + 1
    assert alns[0].get("seq_to", 0) < alns[1].get("seq_from", 10**9)

    assert main(args + ["--format", "tsv"]) == 0
    text = capsys.readouterr().out
    assert "domain 1" in text and "domain 2" in text

    # --msa-out: the hmmsearch -A Stockholm MSA of all hit domains
    msa = tmp_path / "hits.sto"
    assert main(args + ["--msa-out", str(msa)]) == 0
    capsys.readouterr()
    sto = msa.read_text()
    assert sto.startswith("# STOCKHOLM 1.0") and sto.rstrip().endswith("//")
    doms = [ln for ln in sto.splitlines() if ln.startswith("seq0/")]
    assert len(doms) == 2  # one MSA row per hit domain
    # gated: --msa-out without --align is a usage error
    bad = [a for a in args if a != "--align"] + ["--msa-out", str(msa)]
    assert main(bad) == 2


def test_cli_align_subcommand(tmp_path, profile_dir, capsys):
    """`align` (hmmalign-shaped): Viterbi-aligns every sequence, no
    thresholds; consensus aligns as identities over the full model."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.traceback import consensus_string

    hmm = __import__("hmm_fasta_viterbi").parse_hmm(
        profile_dir / "100.hmm"
    )
    cons = consensus_string(P7Profile.from_profile(hmm))
    fasta = tmp_path / "db.fsa"
    fasta.write_text(f">hitseq\n{cons}\n")
    args = ["align", "--hmm", str(profile_dir / "100.hmm"),
            "--fasta", str(fasta)]
    assert main(args + ["--format", "json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows[0]["target"] == "hitseq"
    a = rows[0]["alignments"][0]
    assert (a["hmm_from"], a["hmm_to"]) == (1, hmm.model_length - 1)
    assert a["aseq"].upper().replace("-", "") == cons

    assert main(args) == 0  # tsv renders blocks
    out = capsys.readouterr().out
    assert "hitseq" in out and "domain 1" in out

    assert main(args + ["--format", "stockholm"]) == 0  # one MSA
    sto = capsys.readouterr().out
    assert sto.startswith("# STOCKHOLM 1.0")
    assert sto.rstrip().endswith("//")
    row = next(
        ln for ln in sto.splitlines()
        if ln.startswith("hitseq/")
    )
    assert row.split()[1].replace("-", "").replace(".", "").upper() == cons


def test_cli_scan_stream_matches_whole(tmp_path, profile_dir, capsys):
    """--stream N produces the same report as the whole-file scan
    (scores, p/E-values with the TRUE total database size)."""
    rng = np.random.default_rng(7)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    fasta = tmp_path / "db.fsa"
    fasta.write_text(
        "".join(
            f">s{i}\n" + "".join(aas[k] for k in rng.integers(0, 20, 40 + 13 * i)) + "\n"
            for i in range(7)
        )
    )
    args = ["scan", "--hmm", str(profile_dir / "100.hmm"),
            "--fasta", str(fasta), "--msv-impl", "xla", "--format", "json"]
    assert main(args) == 0
    whole = {r["target"]: r for r in json.loads(capsys.readouterr().out)}
    assert main(args + ["--stream", "3"]) == 0
    streamed = json.loads(capsys.readouterr().out)
    assert len(streamed) == len(whole) == 7
    for r in streamed:
        want = whole[r["target"]]
        assert r["score_nats"] == pytest.approx(want["score_nats"], abs=1e-4)
        assert r["evalue"] == pytest.approx(want["evalue"], rel=1e-6)


def test_cli_scan_stream_p7_stages(tmp_path, profile_dir, capsys):
    """--stream generalizes to the viterbi/forward single-score stages
    (round 3: was msv-only)."""
    rng = np.random.default_rng(3)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    fasta = tmp_path / "db.fsa"
    fasta.write_text(
        "".join(
            f">s{i}\n" + "".join(aas[k] for k in rng.integers(0, 20, 30 + 9 * i)) + "\n"
            for i in range(5)
        )
    )
    for stage in ("viterbi", "forward"):
        args = ["scan", "--hmm", str(profile_dir / "100.hmm"),
                "--fasta", str(fasta), "--msv-impl", "xla",
                "--stage", stage, "--format", "json"]
        assert main(args) == 0
        whole = {r["target"]: r for r in json.loads(capsys.readouterr().out)}
        assert main(args + ["--stream", "2"]) == 0
        streamed = json.loads(capsys.readouterr().out)
        assert len(streamed) == len(whole) == 5
        for r in streamed:
            want = whole[r["target"]]
            assert r["score_nats"] == pytest.approx(
                want["score_nats"], abs=1e-4
            )
            assert r["evalue"] == pytest.approx(want["evalue"], rel=1e-6)


def test_cli_search_stream_matches_whole(tmp_path, profile_dir, capsys):
    """--stream with --stage search: per-batch compaction to MSV
    survivors reproduces the whole-file cascade report — same row set,
    scores, and domain envelopes — with hits split across batches."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.traceback import consensus_string

    hmm = __import__("hmm_fasta_viterbi").parse_hmm(
        profile_dir / "100.hmm"
    )
    cons = consensus_string(P7Profile.from_profile(hmm))
    rng = np.random.default_rng(11)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    recs = [
        f">rnd{i}\n" + "".join(aas[k] for k in rng.integers(0, 20, 60 + 17 * i))
        for i in range(6)
    ]
    recs.insert(1, f">hitA\n{cons}")  # lands in stream batch 1 of 3
    recs.insert(5, f">hitB\n{cons}")  # lands in stream batch 2 of 3
    fasta = tmp_path / "db.fsa"
    fasta.write_text("\n".join(recs) + "\n")
    args = ["scan", "--hmm", str(profile_dir / "100.hmm"),
            "--fasta", str(fasta), "--msv-impl", "xla", "--stage", "search",
            "--format", "json", "--domains"]
    assert main(args) == 0
    whole = {r["target"]: r for r in json.loads(capsys.readouterr().out)}
    assert main(args + ["--stream", "3"]) == 0
    streamed = json.loads(capsys.readouterr().out)
    assert {r["target"] for r in streamed} == set(whole)
    assert {r["target"] for r in streamed if r["hit"]} == {"hitA", "hitB"}
    for r in streamed:
        want = whole[r["target"]]
        assert r["msv_bits"] == pytest.approx(want["msv_bits"], abs=1e-4)
        assert r["forward_p"] == pytest.approx(want["forward_p"], rel=1e-3)
        if r["hit"]:
            assert r.get("ndom") == want.get("ndom")
            assert (r.get("env_from"), r.get("env_to")) == (
                want.get("env_from"), want.get("env_to")
            )
            assert [d["score_nats"] for d in r["domains"]] == pytest.approx(
                [d["score_nats"] for d in want["domains"]], abs=1e-3
            )


def test_cli_search_evalue_top_cutoff(tmp_path, profile_dir, capsys):
    """Search reports carry E-values = forward_p x TRUE database size
    (streamed searches use the total scanned, not the survivor count);
    --top and --max-evalue filter the report rows."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.traceback import consensus_string

    hmm = __import__("hmm_fasta_viterbi").parse_hmm(
        profile_dir / "100.hmm"
    )
    cons = consensus_string(P7Profile.from_profile(hmm))
    rng = np.random.default_rng(5)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    recs = [f">hitA\n{cons}", f">hitB\n{cons[:80]}"]
    recs += [
        f">rnd{i}\n" + "".join(aas[k] for k in rng.integers(0, 20, 120))
        for i in range(4)
    ]
    fasta = tmp_path / "db.fsa"
    fasta.write_text("\n".join(recs) + "\n")
    args = ["scan", "--hmm", str(profile_dir / "100.hmm"),
            "--fasta", str(fasta), "--msv-impl", "xla", "--stage", "search",
            "--format", "json"]
    assert main(args) == 0
    whole = json.loads(capsys.readouterr().out)
    hits = {r["target"]: r for r in whole if r["hit"]}
    assert set(hits) == {"hitA", "hitB"}
    for r in hits.values():  # E = p x N with N = 6 (whole database)
        assert r["evalue"] == pytest.approx(r["forward_p"] * 6, rel=1e-9)
    # streamed: same E-values (true total, not the 2 survivors)
    assert main(args + ["--stream", "2"]) == 0
    streamed = {r["target"]: r for r in json.loads(capsys.readouterr().out)}
    for t, r in hits.items():
        assert streamed[t]["evalue"] == pytest.approx(r["evalue"], rel=1e-6)
    # --top 1 keeps only the best-Forward row
    assert main(args + ["--top", "1"]) == 0
    assert len(json.loads(capsys.readouterr().out)) == 1
    # --max-evalue drops rows above the cutoff (and NaN rows)
    cut = float(hits["hitA"]["evalue"]) * 1.5
    assert main(args + ["--max-evalue", str(cut)]) == 0
    kept = json.loads(capsys.readouterr().out)
    assert {r["target"] for r in kept} <= {"hitA", "hitB"}
    assert all(r["evalue"] <= cut for r in kept)
    assert "hitA" in {r["target"] for r in kept}


def test_cli_search_json_is_strict(tmp_path, profile_dir, capsys):
    """MSV survivors that never reached Viterbi/Forward have NaN p/E
    values; the JSON report must emit null for them (bare NaN is invalid
    JSON for strict parsers — ADVICE r3)."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.traceback import consensus_string

    hmm = __import__("hmm_fasta_viterbi").parse_hmm(profile_dir / "100.hmm")
    cons = consensus_string(P7Profile.from_profile(hmm))
    rng = np.random.default_rng(7)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    recs = [f">hit\n{cons}"]
    recs += [
        f">rnd{i}\n" + "".join(aas[k] for k in rng.integers(0, 20, 120))
        for i in range(5)
    ]
    fasta = tmp_path / "db.fsa"
    fasta.write_text("\n".join(recs) + "\n")
    # msv_p 1.0: EVERY row survives MSV, so the random rows reach the
    # report with NaN viterbi/forward p-values unless later stages ran
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"msv_p": 1.0}))
    base = [
        "scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta),
        "--msv-impl", "xla", "--stage", "search", "--config", str(cfg),
    ]
    assert main(base + ["--format", "json"]) == 0
    raw = capsys.readouterr().out

    def _reject(const):  # strict parser: bare NaN/Infinity must not appear
        raise AssertionError(f"non-strict JSON constant {const!r} in report")

    rows = json.loads(raw, parse_constant=_reject)
    assert any(r["hit"] for r in rows)
    non_hits = [r for r in rows if not r["hit"]]
    assert non_hits, "expected MSV survivors that failed later stages"
    assert any(
        r["forward_p"] is None or r["evalue"] is None for r in non_hits
    )
    # TSV path renders the same rows without crashing on null cells
    assert main(base) == 0
    out = capsys.readouterr().out
    assert "nan" in out  # unreached stages print as nan cells


def test_cli_align_stream_matches_whole(tmp_path, profile_dir, capsys):
    """align --stream: identical output to the whole-file align."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.traceback import consensus_string

    hmm = __import__("hmm_fasta_viterbi").parse_hmm(
        profile_dir / "100.hmm"
    )
    cons = consensus_string(P7Profile.from_profile(hmm))
    fasta = tmp_path / "db.fsa"
    fasta.write_text(
        f">a\n{cons}\n>b\n{cons[:60]}\n>c\n{cons[20:]}\n"
    )
    args = ["align", "--hmm", str(profile_dir / "100.hmm"),
            "--fasta", str(fasta), "--format", "json"]
    assert main(args) == 0
    whole = capsys.readouterr().out
    assert main(args + ["--stream", "2"]) == 0
    assert capsys.readouterr().out == whole


def test_cli_info(profile_dir, capsys):
    """`info` (hmmstat-shaped): parsed NAME/LENG/STATS per profile,
    matching the parser's golden fields; --consensus adds the model
    consensus string."""
    hv = __import__("hmm_fasta_viterbi")
    hmm = hv.parse_hmm(profile_dir / "100.hmm")
    assert main(["info", "--hmm", str(profile_dir / "100.hmm"),
                 "--format", "json", "--consensus"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 1
    r = rows[0]
    assert r["name"] == "Pfam-B_229" and r["leng"] == 100
    assert r["model_length"] == hmm.model_length == 101
    assert r["msv_mu"] == pytest.approx(hmm.stats_local_msv_mu)
    assert r["forward_lambda"] == pytest.approx(
        hmm.stats_local_forward_lambda
    )
    assert len(r["consensus"]) == 100
    # directory form: one row per profile, tsv
    assert main(["info", "--hmm-dir", str(profile_dir)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# file\tname\tleng")
    assert len(out.strip().splitlines()) == 1 + 24
    # exactly one of --hmm / --hmm-dir
    assert main(["info", "--hmm", "x", "--hmm-dir", "y"]) == 2
    assert main(["info"]) == 2


def test_cli_sweep_stream_matches_whole(tmp_path, profile_dir, fasta_dir,
                                        capsys):
    """sweep --stream: one streamed database pass, every profile scanned
    per batch, matches the whole-file sweep (msv and search stages)."""
    import shutil

    hmm_dir = tmp_path / "profiles"
    hmm_dir.mkdir()
    for stem in ("100", "200"):
        shutil.copy(profile_dir / f"{stem}.hmm", hmm_dir)
    fasta = str(fasta_dir / "fasta_like_example.fsa")
    for stage in ("msv", "search"):
        args = ["sweep", "--hmm-dir", str(hmm_dir), "--fasta", fasta,
                "--msv-impl", "xla", "--stage", stage, "--format", "json"]
        assert main(args) == 0
        whole = json.loads(capsys.readouterr().out)
        assert main(args + ["--stream", "2"]) == 0
        streamed = json.loads(capsys.readouterr().out)
        key = "score_nats" if stage == "msv" else "msv_bits"
        w = {(r["profile"], r["target"]): r[key] for r in whole}
        s = {(r["profile"], r["target"]): r[key] for r in streamed}
        assert set(w) == set(s)
        for k in w:
            assert s[k] == pytest.approx(w[k], abs=1e-4)
    # invalid compositions are usage errors
    assert main(args + ["--stream", "2", "--bucketed"]) == 2


def test_cli_align_survives_overbudget_sequence(tmp_path, profile_dir,
                                                capsys, monkeypatch):
    """One over-budget sequence (traceback DP MemoryError) must not
    discard the align run's output (round-3 review)."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops import traceback as tb
    from hmm_fasta_viterbi.ops.traceback import consensus_string

    hmm = __import__("hmm_fasta_viterbi").parse_hmm(
        profile_dir / "100.hmm"
    )
    cons = consensus_string(P7Profile.from_profile(hmm))
    fasta = tmp_path / "db.fsa"
    fasta.write_text(f">good\n{cons}\n>huge\n{cons[:50]}\n>good2\n{cons}\n")
    real = tb.domain_alignments

    def fake(p7, tokens, **kw):
        if len(tokens) == 50:
            raise MemoryError("traceback DP over budget")
        return real(p7, tokens, **kw)

    monkeypatch.setattr("hmm_fasta_viterbi.ops.traceback.domain_alignments", fake)
    assert main(["align", "--hmm", str(profile_dir / "100.hmm"),
                 "--fasta", str(fasta), "--format", "json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["target"] for r in rows] == ["good", "huge", "good2"]
    assert rows[1]["alignments"] == [] and rows[1]["viterbi_nats"] is None
    assert rows[0]["alignments"] and rows[2]["alignments"]


def test_cli_sweep_hmm_db(tmp_path, profile_dir, fasta_dir, capsys):
    """sweep --hmm-db (one concatenated //-separated database file)
    produces the same report as --hmm-dir over the same models; info
    --hmm-db lists every model."""
    db = tmp_path / "pfam.hmm"
    db.write_text(
        (profile_dir / "100.hmm").read_text()
        + (profile_dir / "200.hmm").read_text()
    )
    hmm_dir = tmp_path / "profiles"
    hmm_dir.mkdir()
    import shutil

    for stem in ("100", "200"):
        shutil.copy(profile_dir / f"{stem}.hmm", hmm_dir)
    fasta = str(fasta_dir / "fasta_like_example.fsa")
    common = ["--fasta", fasta, "--msv-impl", "xla", "--format", "json"]
    assert main(["sweep", "--hmm-dir", str(hmm_dir)] + common) == 0
    from_dir = json.loads(capsys.readouterr().out)
    assert main(["sweep", "--hmm-db", str(db)] + common) == 0
    from_db = json.loads(capsys.readouterr().out)
    key = lambda r: (r["profile"], r["target"])
    assert {key(r): r["score_nats"] for r in from_db} == {
        key(r): r["score_nats"] for r in from_dir
    }
    # exactly one source is a usage error
    assert main(["sweep", "--hmm-dir", str(hmm_dir), "--hmm-db", str(db)]
                + common) == 2
    assert main(["sweep"] + common) == 2
    # info over the concatenated database
    assert main(["info", "--hmm-db", str(db), "--format", "json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["name"] for r in rows] == ["Pfam-B_229", "Pfam-B_603"]


def test_cli_sweep_rejects_bad_collections(tmp_path, profile_dir, fasta_dir):
    """Duplicate profile NAMEs and invalid flag combinations are usage
    errors, checked BEFORE the profile collection loads (round-3
    review: name-keyed aggregation would garble silently)."""
    db = tmp_path / "dup.hmm"
    one = (profile_dir / "100.hmm").read_text()
    db.write_text(one + one)  # same NAME twice
    fasta = str(fasta_dir / "fasta_like_example.fsa")
    assert main(["sweep", "--hmm-db", str(db), "--fasta", fasta]) == 2
    assert main(["sweep", "--hmm-db", str(db), "--fasta", fasta,
                 "--stream", "2"]) == 2
    # checkpoint + bucketed would silently drop bucketing before
    assert main(["sweep", "--hmm-dir", str(profile_dir), "--fasta", fasta,
                 "--checkpoint", str(tmp_path / "ck"), "--bucketed"]) == 2
    # targeted messages for swapped/missing paths
    assert main(["sweep", "--hmm-dir", str(tmp_path / "nope"),
                 "--fasta", fasta]) == 1
    assert main(["sweep", "--hmm-db", str(profile_dir),
                 "--fasta", fasta]) == 1
