"""Correctness tests for the NumPy MSV oracle.

Since the reference C++/OpenCL cannot be compiled here (no OpenCL), the
oracle is validated two independent ways:

1. an analytic hand-derivation for tiny cases (single residue);
2. an exponential brute-force enumeration of all MSV segment paths —
   a genuinely independent implementation of the MSV model semantics
   (max over {N-run, s segments separated by J-runs, C-run} paths),
   checked against the DP at the reference's own 1e-4 tolerance
   (algorithms/test_MSV.cpp:10-12).
"""

import itertools
import math

import numpy as np
import pytest

from hmm_fasta_viterbi import MSVProfile, msv_oracle, parse_hmm, parse_hmm_text
from hmm_fasta_viterbi.io.alphabet import BACKGROUND_FREQUENCIES, encode_sequence
from hmm_fasta_viterbi.models.msv import length_transitions

from test_hmm_parsing import MINI_HMM

F = np.float32


@pytest.fixture(scope="module")
def mini_profile():
    return MSVProfile.from_profile(parse_hmm_text(MINI_HMM))


def test_single_residue_analytic(mini_profile):
    """Hand-derived score for sequence 'A' against the LENG=2 mini profile.

    Only path: N(0 residues) -> B -> M_k emits 'A' -> E -> C -> T.
    Best M_k maximizes emission; here emit2 = -0.5 - log(bg_A) > emit1.
    score = emit2 + tr_move + tr_B_Mk + log(1/2) + tr_move
    """
    bg_a = BACKGROUND_FREQUENCIES[0]
    emit2 = F(math.log(math.exp(F(-0.5)) / bg_a))
    tr_move = F(math.log(F(3.0) / F(4.0)))  # L=1
    tr_b_mk = F(math.log(F(2.0) / F(12.0)))  # m=3 -> 2/(3*4)
    expected = emit2 + tr_move + tr_b_mk + F(math.log(0.5)) + tr_move
    got = msv_oracle(mini_profile, encode_sequence("A"))
    assert got == pytest.approx(float(expected), abs=1e-5)


def test_empty_sequence_is_neg_inf(mini_profile):
    assert msv_oracle(mini_profile, np.zeros(0, dtype=np.int32)) == -np.inf


def brute_force_msv(profile: MSVProfile, tokens: np.ndarray) -> float:
    """Independent exponential-path oracle for the MSV model.

    Enumerates every path: an N-run of a residues, then s >= 1 match
    segments (each a contiguous run of model states consuming contiguous
    residues), separated by J-runs, then a C-run, scoring
        a*tr_loop + tr_move                          (N-run, N->B)
      + per segment: tr_B_Mk + sum(emissions)        (B->Mk, matches)
      + per inter-segment gap: tr_E_J + g*tr_loop + tr_move
      + tr_E_C + c*tr_loop + tr_move                 (last E->C, C->T)
    in float64 (order-insensitive check at 1e-4 tolerance).
    """
    L = len(tokens)
    if L == 0:
        return -np.inf
    mr = profile.num_states  # real match states 1..mr
    tr_loop, tr_move = (float(x) for x in length_transitions(L))
    scores = profile.scores_real.astype(np.float64)  # [20, mr]
    trB = float(profile.tr_B_Mk)
    trEC = float(profile.tr_E_C)
    trEJ = float(profile.tr_E_J)

    def segment_score(start_res: int, k: int, start_state: int) -> float:
        # residues start_res..start_res+k-1 matched to states start_state..
        return trB + sum(
            scores[tokens[start_res + t], start_state + t - 1] for t in range(k)
        )

    # recursively enumerate ordered segment lists (start, length) with
    # gaps >= 0 between them (zero-length J-gaps = back-to-back segments)
    def all_segment_lists(min_start: int):
        for r0 in range(min_start, L):
            for k in range(1, min(mr, L - r0) + 1):
                yield [(r0, k)]
                for rest in all_segment_lists(r0 + k):
                    yield [(r0, k)] + rest

    best = -np.inf
    for segs in all_segment_lists(0):
        s = len(segs)
        a = segs[0][0]  # N-run length
        total = a * tr_loop + tr_move
        for t, (r0, k) in enumerate(segs):
            # segment scores are independent given the structure, so the
            # best start state can be chosen per segment
            total += max(segment_score(r0, k, j0) for j0 in range(1, mr - k + 2))
            if t + 1 < s:
                gap = segs[t + 1][0] - (r0 + k)
                total += trEJ + gap * tr_loop + tr_move
        c = L - (segs[-1][0] + segs[-1][1])
        total += trEC + c * tr_loop + tr_move
        best = max(best, total)
    return best


@pytest.mark.parametrize(
    "seq",
    ["A", "AC", "ACD", "ACDEF", "YWVGH", "AAAAAA", "CAY"],
)
def test_oracle_vs_brute_force_mini(mini_profile, seq):
    tokens = encode_sequence(seq)
    dp = float(msv_oracle(mini_profile, tokens))
    bf = brute_force_msv(mini_profile, tokens)
    assert dp == pytest.approx(bf, abs=1e-4)


def test_oracle_vs_brute_force_100(profile_dir):
    """Brute force against a real Pfam profile (m=101), short sequences."""
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    rng = np.random.default_rng(0)
    for L in (1, 2, 3, 4):
        tokens = rng.integers(0, 20, size=L).astype(np.int32)
        dp = float(msv_oracle(profile, tokens))
        bf = brute_force_msv(profile, tokens)
        assert dp == pytest.approx(bf, abs=1e-4)


def test_scores_real_is_finite(profile_dir):
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    assert np.all(np.isfinite(profile.scores_real))
    assert np.all(np.isneginf(profile.scores[:, 0]))


def test_transition_constants(profile_dir):
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    m = 101
    assert profile.tr_B_Mk == pytest.approx(math.log(2.0 / (m * (m + 1))), rel=1e-6)
    assert profile.tr_E_C == pytest.approx(math.log(0.5), rel=1e-6)
    assert profile.tr_E_J == pytest.approx(math.log(0.5), rel=1e-6)
    tr_loop, tr_move = length_transitions(3500)
    assert tr_loop == pytest.approx(math.log(3500 / 3503), abs=1e-6)
    assert tr_move == pytest.approx(math.log(3 / 3503), rel=1e-6)
