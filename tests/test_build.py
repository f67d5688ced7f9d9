"""hmmbuild-shaped pipeline: MSA -> profile -> .hmm -> scan.

Two contracts:
* the writer round-trips through BOTH this package's parsers (python
  and, when available, native) with float error bounded by the 5-decimal
  text encoding;
* the built+calibrated profile discriminates: sequences sampled from
  the SOURCE profile score as hits against the REBUILT profile, while
  random sequences do not (the end-to-end reason build exists).
"""

import io as _io
import contextlib
import json

import numpy as np
import pytest

from hmm_fasta_viterbi.cli import main
from hmm_fasta_viterbi.io.hmmio import parse_hmm
from hmm_fasta_viterbi.io.hmmwrite import write_hmm
from hmm_fasta_viterbi.io.msaio import read_msa
from hmm_fasta_viterbi.models.build import build_profile, calibrate_profile


def test_writer_roundtrips_real_profile(profile_dir, tmp_path):
    """write_hmm(parse_hmm(P)) == P up to the 5-decimal -log encoding,
    through both loaders."""
    src = parse_hmm(profile_dir / "100.hmm")
    out = tmp_path / "rt.hmm"
    write_hmm(src, out)
    for prefer in ("python", "native"):
        from hmm_fasta_viterbi.io.loader import load_profile

        try:
            rt = load_profile(out, prefer=prefer)
        except Exception:
            if prefer == "native":
                pytest.skip("native loader unavailable")
            raise
        assert rt.name == src.name
        assert rt.model_length == src.model_length
        np.testing.assert_allclose(
            rt.match_emissions, src.match_emissions, atol=2e-5
        )
        np.testing.assert_allclose(
            rt.insert_emissions, src.insert_emissions, atol=2e-5
        )
        np.testing.assert_allclose(rt.transitions, src.transitions, atol=2e-5)
        assert rt.stats_local_msv_mu == pytest.approx(
            src.stats_local_msv_mu, abs=1e-3
        )
        assert rt.stats_local_forward_lambda == pytest.approx(
            src.stats_local_forward_lambda, abs=1e-4
        )


def test_build_profile_from_trivial_msa():
    """Three identical gap-free rows: every column is a match column,
    emissions concentrate on the observed residue, and the M->M chain
    dominates transitions."""
    rows = ["ACDEF", "ACDEF", "ACDEF"]
    hmm = build_profile(rows, name="tiny")
    assert hmm.model_length == 6
    for k, aa in enumerate([0, 1, 2, 3, 4], start=1):  # A C D E F
        assert np.argmax(hmm.match_emissions[k]) == aa
        assert hmm.match_emissions[k, aa] > 0.7
    assert (hmm.transitions[1:5, 0] > 0.7).all()  # m->m dominates
    # deletion-heavy column drops out under gap-majority
    hmm2 = build_profile(["AC-EF", "AC-EF", "ACDEF"], name="gappy")
    assert hmm2.model_length == 5  # column 3 is majority-gap -> insert


def test_emit_align_build_scan_loop(profile_dir, tmp_path, capsys):
    """The full family loop: emit samples from 100.hmm, align them
    (Stockholm + RF), build+calibrate a NEW profile from that MSA, then
    scan: the samples hit the rebuilt profile, random sequences do not."""
    src = str(profile_dir / "100.hmm")
    samples = tmp_path / "samples.fsa"
    assert main(["emit", "--hmm", src, "--count", "20", "--seed", "5",
                 "--out", str(samples)]) == 0
    capsys.readouterr()
    msa = tmp_path / "samples.sto"
    assert main(["align", "--hmm", src, "--fasta", str(samples),
                 "--format", "stockholm", "--out", str(msa)]) == 0
    capsys.readouterr()
    names, rows, rf = read_msa(msa)
    assert len(rows) >= 18 and rf is not None  # RF rides through

    built = tmp_path / "rebuilt.hmm"
    assert main(["build", "--msa", str(msa), "--out", str(built),
                 "--name", "rebuilt"]) == 0
    capsys.readouterr()
    rb = parse_hmm(built)
    assert rb.name == "rebuilt"
    # RF has one x per model node -> LENG matches the source model
    assert abs(rb.model_length - 101) <= 2

    # discriminative check through the real CLI cascade
    rng = np.random.default_rng(1)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    with open(samples, "a") as f:
        for i in range(10):
            f.write(f">rnd{i}\n"
                    + "".join(aas[k] for k in rng.integers(0, 20, 100))
                    + "\n")
    assert main(["scan", "--hmm", str(built), "--fasta", str(samples),
                 "--msv-impl", "xla", "--stage", "search",
                 "--format", "json"]) == 0
    rows_out = json.loads(capsys.readouterr().out)
    hits = {r["target"] for r in rows_out if r["hit"]}
    assert sum(1 for t in hits if "sample" in t) >= 18
    assert not any("rnd" in t for t in hits)


def test_pb_weights_derate_redundant_copies():
    """Henikoff position-based weighting: ten identical copies share
    one vote, so the lone divergent sequence's residues keep real
    probability mass (H3's default weighting; --weighting none drowns
    them)."""
    rows = ["ACDEF"] * 10 + ["WWWWW"]  # one fully divergent sequence
    pb = build_profile(rows, name="pb", weighting="pb")
    flat = build_profile(rows, name="flat", weighting="none")
    W = 18  # alphabet index of W
    # every column is 2-type (k=2): the ten copies share one vote, the
    # divergent row keeps its own -> near-equal mass in each column
    assert pb.match_emissions[2, W] > 0.35
    assert flat.match_emissions[2, W] < 0.15  # drowned 1-in-11 without
    assert pb.match_emissions[2, W] > 3 * flat.match_emissions[2, W]
    with pytest.raises(ValueError):
        build_profile(rows, weighting="bogus")


def test_writer_keeps_structural_stars(profile_dir, tmp_path):
    """The last node's m->d / d->d are ALWAYS written as '*': a
    default-quirk parse stores prob 1.0 there, and writing that back
    as 0.00000 would turn an impossibility into a certainty for
    star_as_zero_prob consumers like emit (round-3 review)."""
    src = parse_hmm(profile_dir / "100.hmm")  # default quirk parse
    out = tmp_path / "rt.hmm"
    write_hmm(src, out)
    star = parse_hmm(out, star_as_zero_prob=True)
    last = star.model_length - 1
    assert star.transitions[last, 2] == 0.0  # m->d impossible
    assert star.transitions[last, 6] == 0.0  # d->d impossible
    # while the default parse still round-trips the quirk value 1.0
    quirk = parse_hmm(out)
    assert quirk.transitions[last, 2] == 1.0


def test_msaio_rejects_malformed(tmp_path):
    from hmm_fasta_viterbi.io.msaio import MSAParseError

    bad = tmp_path / "bad.sto"
    bad.write_text("# STOCKHOLM 1.0\n#=GC RF\nrow1 ACD\n//\n")
    with pytest.raises(MSAParseError):
        read_msa(bad)
    ragged = tmp_path / "ragged.sto"
    ragged.write_text("# STOCKHOLM 1.0\nrow1 ACD\nrow2 AC\n//\n")
    with pytest.raises(MSAParseError):
        read_msa(ragged)
