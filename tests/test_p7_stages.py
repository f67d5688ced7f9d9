"""Viterbi / Forward stages through the scanner (MSVScanner.scan_p7: the
staged, device-resident XLA scan of ops.p7_scan) against the NumPy
oracle.

Oracle chain: brute-force path enumeration -> sequential NumPy oracle
(test_p7.py) -> the staged stage scan here, over ragged batches, padded
widths, several profile shapes and the '*' d->d quirk.
"""

import numpy as np
import pytest

from hmm_fasta_viterbi import parse_hmm, parse_hmm_text
from hmm_fasta_viterbi.models.p7 import P7Profile
from hmm_fasta_viterbi.ops.reference import (
    forward_oracle_batch,
    viterbi_oracle_batch,
)
from hmm_fasta_viterbi.pipeline import MSVScanner

from test_hmm_parsing import MINI_HMM

TOL = {"viterbi": 1e-4, "forward": 2e-3}
ORACLE = {"viterbi": viterbi_oracle_batch, "forward": forward_oracle_batch}
STAGES = ("viterbi", "forward")


def _ragged(seed=1, n=6, width=128):
    rng = np.random.default_rng(seed)
    lengths = np.minimum(
        np.array([64, 1, 33, width, 17, 2][:n], dtype=np.int32), width
    )
    tokens = rng.integers(0, 20, size=(n, width)).astype(np.int32)
    return tokens, lengths


def _mini(**overrides):
    p7 = P7Profile.from_profile(parse_hmm_text(MINI_HMM))
    fields = {f: getattr(p7, f) for f in p7.__dataclass_fields__}
    fields.update(overrides)
    return P7Profile(**fields)


def _profile(name, profile_dir):
    if name == "mini":
        return _mini()
    if name == "mini_weak_damping":
        # near-free deletions (tdd = log 0.98) make long delete runs
        # competitive: the delete chain decides the score
        p7 = _mini()
        tdd = np.where(np.isfinite(p7.tdd), np.float32(np.log(0.98)), p7.tdd)
        return _mini(tdd=tdd.astype(np.float32))
    if name == "mini_insert_biased":
        # insert emissions biased toward 'A' (token 0): per-step odds
        # grow, the case where junk past a lane's length would leak
        biased = MINI_HMM.replace("          3.0  ", "          0.05  ")
        return P7Profile.from_profile(parse_hmm_text(biased))
    return P7Profile.from_profile(parse_hmm(profile_dir / f"{name}.hmm"))


def _batch(kind):
    rng = np.random.default_rng(7)
    if kind == "ragged":
        return _ragged(seed=1)
    if kind == "ragged_small":
        return _ragged(seed=4, n=4, width=32)
    if kind == "long":
        # many length buckets of work per lane, two lanes of different
        # length ending in the same bucket
        return (
            rng.integers(0, 20, size=(2, 700)).astype(np.int32),
            np.array([700, 512], dtype=np.int32),
        )
    if kind == "junk_tail":
        # the short lane's positions past its length hold real residues
        # ('A' = 0, what FastaDatabase.encode pads with)
        tokens = np.zeros((2, 512), dtype=np.int32)
        tokens[0] = rng.integers(0, 20, size=512)
        return tokens, np.array([512, 6], dtype=np.int32)
    if kind == "wide_batch":
        # 260 rows: more than one batch bucket
        tokens = rng.integers(0, 20, size=(260, 48)).astype(np.int32)
        lengths = np.full(260, 48, dtype=np.int32)
        lengths[3], lengths[200] = 17, 1
        return tokens, lengths
    raise KeyError(kind)


CASES = [
    ("100", "ragged"),
    ("200", "ragged"),
    ("mini", "ragged_small"),
    ("mini_weak_damping", "ragged_small"),
    ("mini_insert_biased", "junk_tail"),
    ("100", "long"),
    ("100", "wide_batch"),
]


@pytest.fixture(scope="module")
def scanner():
    return MSVScanner(msv_impl="xla")


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name,kind", CASES)
def test_scan_p7_vs_oracle(scanner, profile_dir, name, kind, stage):
    p7 = _profile(name, profile_dir)
    tokens, lengths = _batch(kind)
    got = np.asarray(scanner.scan_p7(p7, scanner.stage(tokens, lengths), stage))
    assert got.shape == (len(lengths),)
    # the oracle is a per-residue Python loop: hold it to a sample
    rows = np.arange(len(lengths))[:8]
    want = ORACLE[stage](p7, tokens[rows], lengths[rows])
    np.testing.assert_allclose(got[rows], want, atol=TOL[stage], rtol=0)
    assert np.isfinite(got[lengths > 0]).all()


@pytest.mark.parametrize("stage", STAGES)
def test_scan_p7_padding_invariance(scanner, profile_dir, stage):
    """A wider padded width (another length bucket) must not change a
    single score: pad steps are masked, not scored."""
    p7 = _profile("100", profile_dir)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 20, size=(2, 50)).astype(np.int32)
    lengths = np.array([50, 31], dtype=np.int32)
    a = np.asarray(scanner.scan_p7(p7, scanner.stage(tokens, lengths), stage))
    wider = np.concatenate(
        [tokens, rng.integers(0, 20, size=(2, 300)).astype(np.int32)], axis=1
    )
    b = np.asarray(scanner.scan_p7(p7, scanner.stage(wider, lengths), stage))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", STAGES)
def test_scan_p7_long_sequence_drift(scanner, stage):
    """A 16k-residue sequence: Forward's log-space accumulation and the
    Viterbi max chain must stay within tolerance of the oracle."""
    p7 = _mini()
    rng = np.random.default_rng(5)
    L = 16384
    tokens = rng.integers(0, 20, size=(1, L)).astype(np.int32)
    lengths = np.array([L], dtype=np.int32)
    got = np.asarray(scanner.scan_p7(p7, scanner.stage(tokens, lengths), stage))
    want = ORACLE[stage](p7, tokens, lengths)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_scan_p7_filter_is_exact_viterbi(scanner, profile_dir):
    """The Viterbi prefilter returns the exact Viterbi score (its own
    upper bound), so the cascade never rescores its survivors."""
    p7 = _profile("100", profile_dir)
    tokens, lengths = _ragged(seed=11)
    staged = scanner.stage(tokens, lengths)
    np.testing.assert_array_equal(
        np.asarray(scanner.scan_p7_filter(p7, staged)),
        np.asarray(scanner.scan_p7(p7, staged, "viterbi")),
    )
