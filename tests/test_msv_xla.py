"""Differential tests: NumPy oracle vs jitted XLA scan.

This is the reference's central invariant test (algorithms/test_MSV.cpp):
all 24 profiles x all sequences of fasta_like_example.fsa must agree
within abs 1e-4 across implementations.
"""

import numpy as np
import pytest

from hmm_fasta_viterbi import MSVProfile, msv_oracle_batch, parse_fasta, parse_hmm
from hmm_fasta_viterbi.ops.xla_scan import msv_xla

TOL = 1e-4  # the reference's own cross-implementation tolerance


@pytest.fixture(scope="module")
def example_batch(fasta_dir):
    db = parse_fasta(fasta_dir / "fasta_like_example.fsa")
    tokens, lengths = db.encode(pad_multiple=8)
    return tokens, lengths


def test_full_profile_sweep(all_profile_paths, example_batch):
    """The reference's test_MSV invariant across all 24 Pfam profiles."""
    tokens, lengths = example_batch
    for path in all_profile_paths:
        profile = MSVProfile.from_profile(parse_hmm(path))
        want = msv_oracle_batch(profile, tokens, lengths)
        got = np.asarray(msv_xla(profile, tokens, lengths))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_mixed_lengths_and_padding(profile_dir):
    """Padded steps must be exact no-ops (SURVEY.md hard part (e))."""
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    rng = np.random.default_rng(1)
    lengths = np.array([1, 7, 64, 200, 0, 33], dtype=np.int32)
    L = 256
    tokens = rng.integers(0, 20, size=(len(lengths), L)).astype(np.int32)
    want = msv_oracle_batch(profile, tokens, lengths)
    got = np.asarray(msv_xla(profile, tokens, lengths))
    # L=0 row: both -inf
    assert np.isneginf(got[4]) and np.isneginf(want[4])
    mask = lengths > 0
    np.testing.assert_allclose(got[mask], want[mask], atol=TOL, rtol=0)


def test_padding_invariance(profile_dir):
    """Score must not depend on the amount of tail padding."""
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "200.hmm"))
    rng = np.random.default_rng(2)
    base = rng.integers(0, 20, size=(3, 50)).astype(np.int32)
    lengths = np.array([50, 50, 50], dtype=np.int32)
    a = np.asarray(msv_xla(profile, base, lengths))
    padded = np.concatenate([base, rng.integers(0, 20, size=(3, 78)).astype(np.int32)], axis=1)
    b = np.asarray(msv_xla(profile, padded, lengths))
    np.testing.assert_array_equal(a, b)


def test_unroll_invariance(profile_dir):
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 20, size=(2, 131)).astype(np.int32)
    lengths = np.array([131, 100], dtype=np.int32)
    a = np.asarray(msv_xla(profile, tokens, lengths, unroll=1))
    b = np.asarray(msv_xla(profile, tokens, lengths, unroll=8))
    np.testing.assert_array_equal(a, b)
