"""Viterbi/Forward stage tests.

Root of trust: an exponential brute-force enumeration of ALL paths
through the full P7 local automaton (float64), checked against the
sequential float32 oracle, which in turn checks the batched JAX scans
(with the associative delete-chain scan).
"""

import math

import numpy as np
import pytest

from hmm_fasta_viterbi import parse_hmm, parse_hmm_text
from hmm_fasta_viterbi.io.alphabet import encode_sequence
from hmm_fasta_viterbi.models.msv import length_transitions
from hmm_fasta_viterbi.models.p7 import P7Profile
from hmm_fasta_viterbi.ops.p7_scan import forward_xla, viterbi_xla
from hmm_fasta_viterbi.ops.reference import (
    forward_oracle_batch,
    viterbi_oracle,
    viterbi_oracle_batch,
    forward_oracle,
)

from test_hmm_parsing import MINI_HMM

VIT_TOL = 1e-4  # adds only — match the engine's MSV tolerance
FWD_TOL = 2e-3  # f32 logsumexp ordering differs between impls


@pytest.fixture(scope="module")
def mini_p7():
    return P7Profile.from_profile(parse_hmm_text(MINI_HMM))


@pytest.fixture(scope="module")
def p7_100(profile_dir):
    return P7Profile.from_profile(parse_hmm(profile_dir / "100.hmm"))


def brute_force_paths(p7: P7Profile, tokens: np.ndarray):
    """Enumerate every path through the local multihit automaton.

    Returns (viterbi=max, forward=logsumexp) of path scores in float64.
    States: N (loop emits), B, M_j / I_j / D_j (j 0-based real node),
    E, J (loop emits), C (loop emits), T. No memoization — an
    implementation-independent spec of the model in models/p7.py.
    """
    seq_len = len(tokens)
    mr = p7.num_states
    tr_loop, tr_move = (float(x) for x in length_transitions(seq_len))
    msc = p7.msc.astype(np.float64)
    isc = p7.isc.astype(np.float64)
    scores: list[float] = []

    def from_core(j: int, state: str, pos: int, acc: float):
        # leaving the core is always allowed from M/D (local exit, 0)
        if state in ("M", "D"):
            after_e(pos, acc)
        if state == "M":
            if pos < seq_len and j + 1 < mr:
                from_core(j + 1, "M", pos + 1,
                          acc + float(p7.tmm[j]) + msc[tokens[pos], j + 1])
            if pos < seq_len:
                from_core(j, "I", pos + 1,
                          acc + float(p7.tmi[j]) + isc[tokens[pos], j])
            if j + 1 < mr:
                from_core(j + 1, "D", pos, acc + float(p7.tmd[j]))
        elif state == "I":
            if pos < seq_len and j + 1 < mr:
                from_core(j + 1, "M", pos + 1,
                          acc + float(p7.tim[j]) + msc[tokens[pos], j + 1])
            if pos < seq_len:
                from_core(j, "I", pos + 1,
                          acc + float(p7.tii[j]) + isc[tokens[pos], j])
        elif state == "D":
            if pos < seq_len and j + 1 < mr:
                from_core(j + 1, "M", pos + 1,
                          acc + float(p7.tdm[j]) + msc[tokens[pos], j + 1])
            if j + 1 < mr:
                from_core(j + 1, "D", pos, acc + float(p7.tdd[j]))

    def after_e(pos: int, acc: float):
        # E -> C -> (loop) -> T
        for c_loops in range(seq_len - pos + 1):
            if pos + c_loops <= seq_len:
                if pos + c_loops == seq_len:
                    scores.append(acc + float(p7.tr_E_C) + c_loops * tr_loop + tr_move)
        # E -> J -> (loop) -> B -> next segment
        for j_loops in range(seq_len - pos + 1):
            begin_segment(
                pos + j_loops,
                acc + float(p7.tr_E_J) + j_loops * tr_loop + tr_move,
            )

    def begin_segment(pos: int, acc: float):
        if pos >= seq_len:
            return
        for j in range(mr):
            from_core(
                j, "M", pos + 1,
                acc + float(p7.tr_B_Mk) + msc[tokens[pos], j],
            )

    # N loop prefix then first segment
    for n_loops in range(seq_len + 1):
        begin_segment(n_loops, n_loops * tr_loop + tr_move)

    if not scores:
        return -np.inf, -np.inf
    arr = np.array(scores, dtype=np.float64)
    m = arr.max()
    return float(m), float(m + np.log(np.exp(arr - m).sum()))


@pytest.mark.parametrize("seq", ["A", "AC", "CAY", "ACDE"])
def test_oracles_vs_brute_force(mini_p7, seq):
    tokens = encode_sequence(seq)
    bf_vit, bf_fwd = brute_force_paths(mini_p7, tokens)
    assert float(viterbi_oracle(mini_p7, tokens)) == pytest.approx(bf_vit, abs=VIT_TOL)
    assert float(forward_oracle(mini_p7, tokens)) == pytest.approx(bf_fwd, abs=FWD_TOL)


def test_forward_above_viterbi(p7_100):
    """Forward sums all paths, so it dominates the single best path."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 20, size=40).astype(np.int32)
    vit = float(viterbi_oracle(p7_100, tokens))
    fwd = float(forward_oracle(p7_100, tokens))
    assert fwd >= vit
    assert math.isfinite(vit) and math.isfinite(fwd)


def test_viterbi_xla_vs_oracle(p7_100):
    rng = np.random.default_rng(1)
    lengths = np.array([64, 1, 33, 100, 0, 17], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 128)).astype(np.int32)
    want = viterbi_oracle_batch(p7_100, tokens, lengths)
    got = np.asarray(viterbi_xla(p7_100, tokens, lengths))
    mask = lengths > 0
    np.testing.assert_allclose(got[mask], want[mask], atol=VIT_TOL, rtol=0)
    assert np.isneginf(got[~mask]).all()


def test_forward_xla_vs_oracle(p7_100):
    rng = np.random.default_rng(2)
    lengths = np.array([48, 100, 7], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 100)).astype(np.int32)
    want = forward_oracle_batch(p7_100, tokens, lengths)
    got = np.asarray(forward_xla(p7_100, tokens, lengths))
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)


def test_viterbi_dominates_msv_paths(p7_100, profile_dir):
    """Viterbi >= MSV's best path REscored with real transitions is hard
    to state simply; instead check determinism + padding invariance."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 20, size=(2, 50)).astype(np.int32)
    lengths = np.array([50, 50], dtype=np.int32)
    a = np.asarray(viterbi_xla(p7_100, tokens, lengths))
    padded = np.concatenate([tokens, rng.integers(0, 20, size=(2, 30)).astype(np.int32)], axis=1)
    b = np.asarray(viterbi_xla(p7_100, padded, lengths))
    np.testing.assert_array_equal(a, b)


def test_delete_chain_matters(mini_p7):
    """A profile path using D states must be reachable: force it by
    scoring a 1-residue sequence that must skip into node 2 vs the
    mini profile — D transitions are finite so Viterbi stays finite."""
    tokens = encode_sequence("W")
    v = float(viterbi_oracle(mini_p7, tokens))
    assert math.isfinite(v)
