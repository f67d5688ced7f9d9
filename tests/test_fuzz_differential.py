"""Randomized differential fuzzing: synthetic profiles (beyond the 24
checked-in Pfam files) through every device path vs the NumPy oracles.

Profiles are drawn with adversarial emission ranges (near-zero
probabilities -> scores approaching the clamp, spiky distributions) and
transition rows that exercise the delete chain hard.
"""

import numpy as np
import pytest

from hmm_fasta_viterbi.io.hmmio import ProfileHMM
from hmm_fasta_viterbi.models.msv import MSVProfile
from hmm_fasta_viterbi.models.p7 import P7Profile
from hmm_fasta_viterbi.ops.reference import (
    forward_oracle_batch,
    msv_oracle_batch,
    viterbi_oracle_batch,
)
from hmm_fasta_viterbi.pipeline import MSVScanner


@pytest.fixture(scope="module")
def scanner():
    return MSVScanner(msv_impl="xla", l_chunk=64)


def random_profile(rng: np.random.Generator, leng: int) -> ProfileHMM:
    m = leng + 1
    # spiky Dirichlet-ish emissions with occasional near-zero entries
    me = rng.dirichlet(np.full(20, 0.2), size=m).astype(np.float32)
    me[0] = 0.0  # dummy M0 row
    ie = rng.dirichlet(np.full(20, 1.0), size=m).astype(np.float32)
    # transitions: random but normalized-ish triples; some heavy deletes
    tr = rng.dirichlet(np.full(7, 0.5), size=m).astype(np.float32)
    # push a few nodes toward delete-heavy behavior (big tdd)
    heavy = rng.integers(0, m, size=max(1, m // 4))
    tr[heavy, 6] = 0.95
    return ProfileHMM(
        name=f"fuzz{leng}",
        model_length=m,
        match_emissions=me,
        insert_emissions=ie,
        transitions=tr,
        stats_local_msv_mu=-5.0,
        stats_local_msv_lambda=0.7,
        stats_local_viterbi_mu=-6.0,
        stats_local_viterbi_lambda=0.7,
        stats_local_forward_theta=-2.0,
        stats_local_forward_lambda=0.7,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_msv_packed(scanner, seed):
    """The MSV stage on the kernel's packed table (near-zero emission
    probabilities give scores near -inf in single states)."""
    rng = np.random.default_rng(100 + seed)
    leng = int(rng.integers(3, 60))
    hmm = random_profile(rng, leng)
    profile = MSVProfile.from_profile(hmm)
    lengths = rng.integers(0, 96, size=6).astype(np.int32)
    tokens = rng.integers(0, 20, size=(6, 96)).astype(np.int32)
    want = msv_oracle_batch(profile, tokens, lengths)
    got = np.asarray(scanner.scan(profile, scanner.stage(tokens, lengths)))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-4, rtol=0)
    assert np.all(np.isneginf(got[~finite]))


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_p7_xla(scanner, seed):
    rng = np.random.default_rng(200 + seed)
    leng = int(rng.integers(3, 40))
    hmm = random_profile(rng, leng)
    p7 = P7Profile.from_profile(hmm)
    lengths = np.array([48, 1, 31, 64], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(4, 64)).astype(np.int32)

    staged = scanner.stage(tokens, lengths)
    want_v = viterbi_oracle_batch(p7, tokens, lengths)
    got_v = np.asarray(scanner.scan_p7(p7, staged, stage="viterbi"))
    np.testing.assert_allclose(got_v, want_v, atol=1e-4, rtol=0)

    want_f = forward_oracle_batch(p7, tokens, lengths)
    got_f = np.asarray(scanner.scan_p7(p7, staged, stage="forward"))
    np.testing.assert_allclose(got_f, want_f, atol=2e-3, rtol=0)


def test_fuzz_parsers_raise_cleanly():
    """Mutated inputs must either parse or raise the STRUCTURED parse
    errors — never IndexError/KeyError/UnboundLocal crashes (the
    reference's parsers crash on such inputs — SURVEY.md quirk 5)."""
    from hmm_fasta_viterbi.io.fastaio import FastaParseError, parse_fasta_text
    from hmm_fasta_viterbi.io.hmmio import HMMParseError, parse_hmm_text
    from test_hmm_parsing import MINI_HMM

    rng = np.random.default_rng(7)
    lines = MINI_HMM.splitlines()
    for trial in range(60):
        mutated = list(lines)
        op = trial % 3
        if op == 0:  # truncate
            mutated = mutated[: int(rng.integers(0, len(lines)))]
        elif op == 1:  # drop a random line
            del mutated[int(rng.integers(0, len(mutated)))]
        else:  # corrupt a random line
            i = int(rng.integers(0, len(mutated)))
            mutated[i] = "".join(
                rng.choice(list("abc* .-123\t")) for _ in range(20)
            )
        try:
            parse_hmm_text("\n".join(mutated))
        except HMMParseError:
            pass  # the contract

    fasta_bases = [">a\nACDE\n", "ACDE\n", ">\n\n>", ">x", "", "\n\n", ">y\nZZ@#\n"]
    for trial in range(40):
        base = fasta_bases[trial % len(fasta_bases)]
        chars = list(base)
        if chars:
            i = int(rng.integers(0, len(chars)))
            chars[i] = chr(int(rng.integers(32, 127)))
        try:
            parse_fasta_text("".join(chars))
        except FastaParseError:
            pass  # the contract


def test_prob_forward_pad_overflow_regression():
    """Hundreds of padded steps after short lanes, on a profile whose
    pad residue ('A', token 0) has large odds at every state: a pad step
    that were scored instead of masked would compound those odds until
    the Forward score left f32."""
    rng = np.random.default_rng(99)
    # profile whose token-0 ('A') odds are large at every state
    me = np.full((41, 20), 0.01 / 19, dtype=np.float32)
    me[:, 0] = 0.99
    me[0] = 0.0
    ie = rng.dirichlet(np.full(20, 1.0), size=41).astype(np.float32)
    tr = rng.dirichlet(np.full(7, 1.0), size=41).astype(np.float32)
    hmm = ProfileHMM(
        name="padfuzz", model_length=41, match_emissions=me,
        insert_emissions=ie, transitions=tr,
        stats_local_msv_mu=-5.0, stats_local_msv_lambda=0.7,
        stats_local_viterbi_mu=-6.0, stats_local_viterbi_lambda=0.7,
        stats_local_forward_theta=-2.0, stats_local_forward_lambda=0.7,
    )
    p7 = P7Profile.from_profile(hmm)
    # short lengths + a big l_chunk -> hundreds of padded steps
    sc = MSVScanner(msv_impl="xla", l_chunk=256)
    lengths = np.array([10, 9, 12, 15, 4, 2], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(6, 17)).astype(np.int32)
    staged = sc.stage(tokens, lengths)
    got = np.asarray(sc.scan_p7(p7, staged, stage="forward"))
    assert np.all(np.isfinite(got)), got
    want = forward_oracle_batch(p7, tokens, lengths)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_viterbi_filter_bound(scanner, seed):
    """Upper-bound invariant of the Viterbi prefilter (the exact Viterbi
    score) under random profiles with delete-heavy transitions."""
    rng = np.random.default_rng(300 + seed)
    leng = int(rng.integers(3, 40))
    hmm = random_profile(rng, leng)
    p7 = P7Profile.from_profile(hmm)
    lengths = np.array([48, 1, 31, 64], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(4, 64)).astype(np.int32)
    exact = viterbi_oracle_batch(p7, tokens, lengths)
    filt = np.asarray(
        scanner.scan_p7_filter(p7, scanner.stage(tokens, lengths))
    )
    assert np.all(filt >= exact - 1e-4), (filt - exact).min()


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_posterior_coverage(seed):
    """The batched posterior decode vs the NumPy posterior oracle on
    random profiles."""
    from hmm_fasta_viterbi.ops.p7_scan import posterior_coverage_batch_xla
    from hmm_fasta_viterbi.ops.reference import posterior_match

    rng = np.random.default_rng(400 + seed)
    leng = int(rng.integers(3, 30))
    hmm = random_profile(rng, leng)
    p7 = P7Profile.from_profile(hmm)
    lengths = np.array([40, 3, 25], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(3, 40)).astype(np.int32)
    cov, tot = posterior_coverage_batch_xla(p7, tokens, lengths)
    for b in range(3):
        post, total = posterior_match(p7, tokens[b, : lengths[b]])
        assert float(tot[b]) == pytest.approx(float(total), abs=2e-3)
        np.testing.assert_allclose(
            cov[b, : lengths[b]], post.sum(axis=1), atol=2e-3, rtol=0
        )
