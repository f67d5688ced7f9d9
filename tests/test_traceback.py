"""Viterbi traceback / domain alignment tests (ops.traceback).

Oracle chain: the walked path's score is recomputed by an INDEPENDENT
walker here (emission+transition sum over the reported states) and must
reproduce the DP total; the DP total itself must match the sequential
f32 Viterbi oracle (ops.reference.viterbi_oracle) within float noise.
"""

import numpy as np
import pytest

from hmm_fasta_viterbi import parse_hmm
from hmm_fasta_viterbi.io.alphabet import AA_TO_INDEX
from hmm_fasta_viterbi.models.msv import length_transitions
from hmm_fasta_viterbi.models.p7 import P7Profile
from hmm_fasta_viterbi.ops.reference import viterbi_oracle
from hmm_fasta_viterbi.ops.traceback import (
    consensus_string,
    domain_alignments,
    format_alignment,
    viterbi_path,
)


@pytest.fixture(scope="module")
def p7_100(profile_dir):
    return P7Profile.from_profile(parse_hmm(profile_dir / "100.hmm"))


def walk_score(p7, tokens, path):
    """Independent score of a traced path: sum emissions + transitions
    along the reported states (f64). Mirrors the model definition, not
    the DP code."""
    tr_loop, tr_move = length_transitions(len(tokens))
    tr_loop, tr_move = float(tr_loop), float(tr_move)
    total = 0.0
    prev = None
    for state, t, j in path:
        if prev is not None:
            ps, _, pj = prev
            key = (ps, state)
            if key == ("N", "N") or key == ("J", "J") or key == ("C", "C"):
                total += tr_loop
            elif key in (("N", "B"), ("J", "B")):
                total += tr_move
            elif key == ("B", "M"):
                total += float(p7.tr_B_Mk)
            elif key == ("M", "M"):
                total += float(p7.tmm[pj])
            elif key == ("M", "I"):
                total += float(p7.tmi[pj])
            elif key == ("M", "D"):
                total += float(p7.tmd[pj])
            elif key == ("I", "M"):
                total += float(p7.tim[pj])
            elif key == ("I", "I"):
                total += float(p7.tii[pj])
            elif key == ("D", "M"):
                total += float(p7.tdm[pj])
            elif key == ("D", "D"):
                total += float(p7.tdd[pj])
            elif key in (("M", "E"), ("D", "E")):
                pass  # E collects at no cost
            elif key == ("E", "J"):
                total += float(p7.tr_E_J)
            elif key == ("E", "C"):
                total += float(p7.tr_E_C)
            else:
                raise AssertionError(f"illegal transition {key}")
        if state == "M":
            total += float(p7.msc[int(tokens[t - 1]), j])
        elif state == "I":
            total += float(p7.isc[int(tokens[t - 1]), j])
        prev = (state, t, j)
    assert prev is not None and prev[0] == "C"
    return total + tr_move


def test_path_score_matches_oracle(p7_100):
    rng = np.random.default_rng(3)
    for length in (40, 120, 260):
        tokens = rng.integers(0, 20, size=length).astype(np.int32)
        score, path = viterbi_path(p7_100, tokens)
        want = float(viterbi_oracle(p7_100, tokens))
        assert abs(score - want) < 1e-3, (length, score, want)
        assert abs(walk_score(p7_100, tokens, path) - score) < 1e-6
        # emitting states consume tokens in order
        emits = [t for s, t, _ in path if s in ("M", "I")]
        assert emits == sorted(emits)


def test_single_domain_consensus(p7_100):
    cons = consensus_string(p7_100)
    tokens = np.array([AA_TO_INDEX[c] for c in cons], dtype=np.int32)
    score, doms = domain_alignments(p7_100, tokens)
    assert len(doms) == 1
    d = doms[0]
    assert d.hmm_from <= 3 and d.hmm_to >= p7_100.num_states - 2
    assert d.seq_from <= 3 and d.seq_to >= len(tokens) - 2
    # consensus sequence aligns as (near-)identities: most match columns
    ident = sum(1 for c in d.match_line if c.isalpha())
    assert ident > 0.8 * len(d.match_line)
    # ungapped residues reconstruct the sequence slice
    res = d.seq_line.replace("-", "").upper()
    want = cons[d.seq_from - 1 : d.seq_to]
    assert res == want


def test_two_domain_repeat(p7_100):
    """Two consensus repeats separated by a random linker -> the
    multihit path reports ndom = 2 with sane coordinates."""
    rng = np.random.default_rng(9)
    cons = consensus_string(p7_100)
    rep = [AA_TO_INDEX[c] for c in cons]
    linker = rng.integers(0, 20, size=30).tolist()
    tokens = np.array(rep + linker + rep, dtype=np.int32)
    score, doms = domain_alignments(p7_100, tokens)
    assert len(doms) == 2
    a, b = doms
    assert a.seq_to < b.seq_from
    assert a.seq_to <= len(rep) + 2
    assert b.seq_from >= len(rep) + 20
    assert walk_score(p7_100, tokens, viterbi_path(p7_100, tokens)[1]) == (
        pytest.approx(score, abs=1e-6)
    )


def test_format_alignment_block(p7_100):
    cons = consensus_string(p7_100)
    tokens = np.array([AA_TO_INDEX[c] for c in cons], dtype=np.int32)
    _, doms = domain_alignments(p7_100, tokens)
    text = format_alignment(doms[0], "100", "seq1", width=40)
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert any("100" in ln for ln in lines)
    assert any("seq1" in ln for ln in lines)
    # wrapped coordinate bookkeeping: first block starts at the
    # alignment's start coordinates
    assert f"{doms[0].hmm_from:6d}" in lines[0]


def test_stockholm_msa(p7_100):
    """Stockholm MSA over domains: one row per domain in model column
    space; rows equal-width; residue content reconstructs each domain's
    sequence slice; insert runs become lowercase columns RF-marked '.'."""
    from hmm_fasta_viterbi.ops.traceback import stockholm_msa

    rng = np.random.default_rng(5)
    cons = consensus_string(p7_100)
    rep = [AA_TO_INDEX[c] for c in cons]
    mid = len(rep) // 2
    # seqA: plain consensus; seqB: consensus with a 3-residue insertion
    tok_a = np.array(rep, dtype=np.int32)
    tok_b = np.array(
        rep[:mid] + rng.integers(0, 20, size=3).tolist() + rep[mid:],
        dtype=np.int32,
    )
    entries = []
    for name, tok in (("seqA", tok_a), ("seqB", tok_b)):
        _, doms = domain_alignments(p7_100, tok)
        entries.extend((name, d) for d in doms)
    text = stockholm_msa(entries, p7_100.num_states, "100")
    lines = text.splitlines()
    assert lines[0] == "# STOCKHOLM 1.0"
    assert lines[-1] == "//"
    rows = [ln for ln in lines if ln and not ln.startswith(("#", "//"))]
    rf = next(ln for ln in lines if ln.startswith("#=GC RF"))
    seqs = {ln.split()[0]: ln.split()[1] for ln in rows}
    rf_cols = rf.split()[-1]
    assert len(rf_cols) == p7_100.num_states + 3  # 3 insert columns
    assert all(len(s) == len(rf_cols) for s in seqs.values())
    # every x column is a match node in order; '.' columns are inserts
    assert rf_cols.count("x") == p7_100.num_states
    # rows reconstruct their sequences (letters only, in order)
    for (name, dom), tok in zip(entries, (tok_a, tok_b)):
        row = seqs[f"{name}/{dom.seq_from}-{dom.seq_to}"]
        got = [c.upper() for c in row if c.isalpha()]
        from hmm_fasta_viterbi.io.alphabet import AMINO_ACIDS

        want = [AMINO_ACIDS[t] for t in tok[dom.seq_from - 1 : dom.seq_to]]
        assert got == want
    # the insertion shows as lowercase in seqB's row under RF '.'
    row_b = next(v for k, v in seqs.items() if k.startswith("seqB"))
    ins_cols = [i for i, c in enumerate(rf_cols) if c == "."]
    assert any(row_b[i].islower() for i in ins_cols)


def test_no_alignment_on_empty():
    from hmm_fasta_viterbi import parse_hmm_text

    from test_hmm_parsing import MINI_HMM

    p7 = P7Profile.from_profile(parse_hmm_text(MINI_HMM))
    score, path = viterbi_path(p7, np.zeros(0, dtype=np.int32))
    assert score == -np.inf and path == []


def test_hit_alignments_envelope_fallback(p7_100, monkeypatch):
    """Past the DP budget, hit_alignments aligns each posterior envelope
    subsequence and shifts coordinates back; with no envelopes it
    re-raises (round-3 review: no swap-death on genome-scale input)."""
    import hmm_fasta_viterbi.ops.traceback as tb

    cons = consensus_string(p7_100)
    rep = [AA_TO_INDEX[c] for c in cons]
    rng = np.random.default_rng(2)
    linker = rng.integers(0, 20, size=40).tolist()
    tokens = np.array(rep + linker + rep, dtype=np.int32)

    full = tb.hit_alignments(p7_100, tokens)
    # budget sized so the 240-residue full DP fails but each ~100-residue
    # envelope subsequence fits
    monkeypatch.setattr(tb, "TRACEBACK_MAX_GIB", 4e-4)
    with pytest.raises(MemoryError):
        tb.hit_alignments(p7_100, tokens)
    env = [(1, len(rep)), (len(rep) + 41, len(tokens))]
    doms = tb.hit_alignments(p7_100, tokens, envelopes=env)
    assert len(doms) == len(full) == 2
    for got, want in zip(doms, full):
        assert abs(got.seq_from - want.seq_from) <= 2
        assert abs(got.seq_to - want.seq_to) <= 2
        assert got.hmm_from == want.hmm_from
