"""Filter-cascade (MSV -> Viterbi -> Forward) tests.

A consensus sequence (per-node argmax match emission) must sail through
all three stages; random sequences must be rejected early.
"""

import numpy as np
import pytest

from hmm_fasta_viterbi import parse_hmm
from hmm_fasta_viterbi.cli import main
from hmm_fasta_viterbi.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi.pipeline import MSVScanner, SearchPipeline


def consensus_sequence(hmm) -> str:
    best = np.argmax(hmm.match_emissions[1:], axis=1)
    return "".join(AMINO_ACIDS[i] for i in best)


@pytest.fixture(scope="module")
def hmm100(profile_dir):
    return parse_hmm(profile_dir / "100.hmm")


@pytest.fixture(scope="module")
def mixed_batch(hmm100):
    rng = np.random.default_rng(21)
    cons = consensus_sequence(hmm100)
    from hmm_fasta_viterbi.io.alphabet import encode_sequence

    cons_tokens = encode_sequence(cons)
    seq_len = max(len(cons), 120)
    tokens = rng.integers(0, 20, size=(5, seq_len)).astype(np.int32)
    lengths = np.full(5, seq_len, dtype=np.int32)
    tokens[2, : len(cons)] = cons_tokens
    lengths[2] = len(cons)
    return tokens, lengths


def test_cascade(hmm100, mixed_batch):
    tokens, lengths = mixed_batch
    scanner = MSVScanner(msv_impl="xla")
    staged = scanner.stage(tokens, lengths)
    result = SearchPipeline(scanner).search(hmm100, staged, tokens, lengths)

    assert result.passed_msv[2]
    assert result.passed_viterbi[2]
    assert result.passed_forward[2]
    assert result.hits.tolist() == [2]
    # random sequences rejected at the first stage
    assert not result.passed_msv[[0, 1, 3, 4]].any()
    # stages only computed for survivors
    assert np.isnan(result.viterbi_scores[0])
    assert np.isfinite(result.viterbi_scores[2])
    # forward dominates viterbi on the survivor
    assert result.forward_scores[2] >= result.viterbi_scores[2]


def test_cli_search_stage(tmp_path, profile_dir, hmm100, capsys):
    cons = consensus_sequence(hmm100)
    fasta = tmp_path / "mix.fsa"
    rng = np.random.default_rng(3)
    rand = "".join(AMINO_ACIDS[i] for i in rng.integers(0, 20, 150))
    write_fasta(fasta, [FastaRecord("rand", rand), FastaRecord("cons", cons)])

    rc = main(
        ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta),
         "--stage", "search", "--msv-impl", "xla"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if not l.startswith("#")]
    assert len(lines) == 1  # only the MSV survivor is reported
    assert lines[0].startswith("cons") and lines[0].rstrip().endswith("1")


@pytest.mark.parametrize("stage", ["viterbi", "forward"])
def test_cli_p7_stages(tmp_path, profile_dir, hmm100, stage, capsys):
    cons = consensus_sequence(hmm100)
    fasta = tmp_path / "c.fsa"
    write_fasta(fasta, [FastaRecord("cons", cons)])
    rc = main(
        ["scan", "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta),
         "--stage", stage]
    )
    assert rc == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if not l.startswith("#")]
    assert len(lines) == 1
    score_bits = float(lines[0].split("\t")[3])
    assert score_bits > 50  # consensus scores far above noise


def test_fast_cascade_identical_hits(hmm100, mixed_batch):
    """fast_msv + fast_viterbi (the prefilter entry points, both exact)
    must produce the same hit set and identical scores on hits as the
    plain cascade."""
    tokens, lengths = mixed_batch
    scanner = MSVScanner(msv_impl="xla", l_chunk=64)
    staged = scanner.stage(tokens, lengths)
    plain = SearchPipeline(scanner).search(hmm100, staged, tokens, lengths)
    fast = SearchPipeline(
        scanner, fast_msv=True, fast_viterbi=True
    ).search(hmm100, staged, tokens, lengths)

    assert fast.hits.tolist() == plain.hits.tolist() == [2]
    np.testing.assert_array_equal(fast.passed_msv, plain.passed_msv)
    np.testing.assert_array_equal(fast.passed_viterbi, plain.passed_viterbi)
    np.testing.assert_array_equal(fast.passed_forward, plain.passed_forward)
    # survivors carry EXACT stage scores in both modes
    for h in fast.hits:
        assert fast.msv_scores[h] == pytest.approx(plain.msv_scores[h], abs=1e-4)
        assert fast.viterbi_scores[h] == pytest.approx(
            plain.viterbi_scores[h], abs=1e-4
        )
        assert fast.forward_scores[h] == pytest.approx(
            plain.forward_scores[h], abs=2e-3
        )


def test_search_caches_bounded_across_batches(hmm100, mixed_batch):
    """Streamed scans call pipeline.search once per FASTA batch with the
    SAME hmm object; the derived MSV/P7 profiles must be memoized so the
    scanner's id-keyed device caches stay bounded (round-3 review: a
    fresh derived profile per batch pinned one profile pack + device
    arrays per batch, an unbounded leak that also re-uploaded the
    profile every batch)."""
    tokens, lengths = mixed_batch
    pipeline = SearchPipeline(MSVScanner(msv_impl="xla"))
    sizes = []
    for _ in range(4):
        staged = pipeline.scanner.stage(tokens, lengths)
        result = pipeline.search(hmm100, staged, tokens, lengths)
        sizes.append(
            (len(pipeline.scanner._profile_cache),
             len(pipeline._derived_cache))
        )
    assert result.passed_forward[2]  # the consensus row still hits
    assert sizes[0] == sizes[-1], sizes  # no growth batch over batch
    assert sizes[-1][1] == 1  # one hmm -> one derived entry


def test_search_bucketed_matches_staged(hmm100, tmp_path, capsys):
    """scan --stage search --bucketed: the bucketed MSV stage feeds the
    same cascade — identical rows to the unbucketed search on a ragged
    database (round 3: --bucketed was msv-only)."""
    import json

    rng = np.random.default_rng(13)
    cons = consensus_sequence(hmm100)
    recs = [FastaRecord(f"r{i}", "".join(
        AMINO_ACIDS[k] for k in rng.integers(0, 20, int(l))
    )) for i, l in enumerate(rng.integers(40, 400, 12))]
    recs.append(FastaRecord("hit", cons))
    fasta = tmp_path / "ragged.fsa"
    write_fasta(fasta, recs)
    from conftest import PROFILE_DIR

    base = ["scan", "--hmm", str(PROFILE_DIR / "100.hmm"),
            "--fasta", str(fasta), "--msv-impl", "xla",
            "--stage", "search", "--format", "json"]
    assert main(base) == 0
    plain = {r["target"]: r for r in json.loads(capsys.readouterr().out)}
    assert main(base + ["--bucketed"]) == 0
    bucketed = {r["target"]: r for r in json.loads(capsys.readouterr().out)}
    assert set(plain) == set(bucketed)
    assert any(r["hit"] for r in bucketed.values())
    for t in plain:
        assert bucketed[t]["msv_bits"] == pytest.approx(
            plain[t]["msv_bits"], abs=1e-4
        )
        assert bucketed[t]["hit"] == plain[t]["hit"]
        assert bucketed[t]["evalue"] == pytest.approx(
            plain[t]["evalue"], rel=1e-6
        )


def test_search_bucketed_fast_prefilter(hmm100, mixed_batch):
    """search_bucketed + fast_msv: the prefilter runs per bucket — hit
    set identical to the plain staged search."""
    tokens, lengths = mixed_batch
    scanner = MSVScanner(msv_impl="xla")
    plain = SearchPipeline(scanner).search(
        hmm100, scanner.stage(tokens, lengths), tokens, lengths
    )
    fast = SearchPipeline(scanner, fast_msv=True)
    bucketed = scanner.stage_bucketed(tokens, lengths)
    got = fast.search_bucketed(hmm100, bucketed, tokens, lengths)
    np.testing.assert_array_equal(got.passed_forward, plain.passed_forward)
    np.testing.assert_array_equal(got.passed_msv, plain.passed_msv)
    # survivors' MSV scores match the exact scan
    surv = np.flatnonzero(got.passed_msv)
    np.testing.assert_allclose(
        got.msv_scores[surv], plain.msv_scores[surv], atol=1e-4
    )
