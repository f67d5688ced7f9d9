"""FASTA parser tests.

The golden 4-record parse mirrors the reference's own FASTA test against
FASTA_files/fasta_like_example.fsa (data_readers/test_fasta_parsing.cpp),
including the '#'-sentinel view; negative-path tests cover the edges the
reference left undefined (SURVEY.md quirks 5/6).
"""

import numpy as np
import pytest

from hmm_fasta_viterbi import parse_fasta, parse_fasta_text
from hmm_fasta_viterbi.io.fastaio import FastaParseError, FastaRecord, write_fasta


def test_example_fasta_golden(fasta_dir):
    db = parse_fasta(fasta_dir / "fasta_like_example.fsa")
    assert db.sequences == [
        "#ACDEFGHIKLMNPQTVWY",
        "#ACDKLMNPQTVWYEFGHI",
        "#EFMNRGHIKLMNPQT",
        "#MKMRFFSSPCGKAAVDPADRCKEVQQIRDQHPSKIPVIIERYKGEKQLPVLDKTKFLVPDHVNMSE"
        "LVKIIRRRLQLNPTQAFFLLVNQHSMVSVSTPIADIYEQEKDEDGFLYMVYASQETFGFIRENE",
    ]
    # multi-line join for the real protein record
    assert len(db.records[3]) == 130
    assert db.records[3].header.startswith("gi|31563518|ref|NP_852610.1|")


def test_random_fasta(fasta_dir):
    db = parse_fasta(fasta_dir / "random_FASTA.fsa")
    assert len(db) == 3
    assert all(len(r) == 3500 for r in db.records)


def test_rejection_of_invalid_symbols():
    text = ">ok\nACDEF\n>bad\nACDXF\n>ok2\nGHIKL\n"
    db = parse_fasta_text(text)
    assert [r.sequence for r in db.records] == ["ACDEF", "GHIKL"]
    assert [r.sequence for r in db.rejected] == ["ACDXF"]


def test_empty_lines_and_whitespace_ok():
    text = ">a\nACD\n\nEF\n\n>b\nGHI\n"
    db = parse_fasta_text(text)
    assert [r.sequence for r in db.records] == ["ACDEF", "GHI"]


def test_data_before_header_raises():
    with pytest.raises(FastaParseError):
        parse_fasta_text("ACDEF\n>late\nGHI\n")


def test_empty_record():
    db = parse_fasta_text(">empty\n>full\nACD\n")
    assert [r.sequence for r in db.records] == ["", "ACD"]
    assert db.sequences[0] == "#"


def test_encode_batch():
    db = parse_fasta_text(">a\nACD\n>b\nACDEF\n")
    tokens, lengths = db.encode(pad_multiple=4)
    assert tokens.shape == (2, 8)
    assert lengths.tolist() == [3, 5]
    assert tokens[0, :3].tolist() == [0, 1, 2]
    assert tokens[1, :5].tolist() == [0, 1, 2, 3, 4]
    assert np.all(tokens[0, 3:] == 0)  # pad token


def test_write_roundtrip(tmp_path):
    recs = [FastaRecord("r0", "ACDEF" * 30), FastaRecord("r1", "GHIKL")]
    path = tmp_path / "out.fsa"
    write_fasta(path, recs)
    db = parse_fasta(path)
    assert [r.sequence for r in db.records] == [r.sequence for r in recs]
    assert [r.header for r in db.records] == ["r0", "r1"]
    # wrapped at 70 columns like the reference generator
    lines = path.read_text().splitlines()
    assert max(len(l) for l in lines) == 70


def test_iter_fasta_batches_matches_whole_file(tmp_path):
    """Streaming batches concatenate to exactly the whole-file parse —
    same records, same order, same rejections — across batch sizes that
    do and do not divide the record count."""
    import numpy as np

    from hmm_fasta_viterbi.io.fastaio import (
        iter_fasta_batches,
        parse_fasta,
    )

    rng = np.random.default_rng(0)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    lines = []
    for i in range(11):
        seq = "".join(aas[k] for k in rng.integers(0, 20, 30 + 7 * i))
        if i == 4:
            seq = seq[:10] + "X" + seq[10:]  # rejected whole
        lines.append(f">rec{i}")
        # wrapped lines like real FASTA
        lines.extend(seq[j : j + 17] for j in range(0, len(seq), 17))
    path = tmp_path / "db.fsa"
    path.write_text("\n".join(lines) + "\n")

    whole = parse_fasta(path)
    assert len(whole) == 10 and len(whole.rejected) == 1
    for n in (1, 3, 10, 100):
        batches = list(iter_fasta_batches(path, batch_records=n))
        recs = [r for b in batches for r in b.records]
        rej = [r for b in batches for r in b.rejected]
        assert [(r.header, r.sequence) for r in recs] == [
            (r.header, r.sequence) for r in whole.records
        ], n
        assert [r.header for r in rej] == ["rec4"]
        assert all(len(b) <= n for b in batches)


def test_iter_fasta_batches_data_before_header(tmp_path):
    from hmm_fasta_viterbi.io.fastaio import (
        FastaParseError,
        iter_fasta_batches,
    )

    path = tmp_path / "bad.fsa"
    path.write_text("ACDEF\n>rec\nACDEF\n")
    with pytest.raises(FastaParseError):
        list(iter_fasta_batches(path))
