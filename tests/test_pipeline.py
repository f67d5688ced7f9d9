"""Pipeline / scanner API tests (staged database, cached profiles)."""

import numpy as np
import pytest

from hmm_fasta_viterbi import MSVProfile, msv_oracle_batch, parse_fasta, parse_hmm
from hmm_fasta_viterbi.ops import msv_cuda
from hmm_fasta_viterbi.pipeline import MSVScanner

TOL = 1e-4


@pytest.fixture(scope="module", params=["xla", "cuda"])
def scanner(request):
    """``cuda``: the scanner's CUDA branch — table packing, stacking by
    width, padding — with the kernel's plain reference standing in for
    the kernel, which needs a card."""
    sc = MSVScanner(msv_impl="xla", l_chunk=64)
    if request.param == "cuda":
        mp = pytest.MonkeyPatch()
        mp.setattr(msv_cuda, "msv_packed", msv_cuda.msv_packed_reference)
        request.addfinalizer(mp.undo)
        sc.msv_impl = "cuda"
    return sc


def test_stage_and_scan(scanner, profile_dir, fasta_dir):
    db = parse_fasta(fasta_dir / "fasta_like_example.fsa")
    tokens, lengths = db.encode()
    staged = scanner.stage(tokens, lengths)
    assert staged.num_sequences == 4
    for stem in ("100", "300"):
        profile = MSVProfile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))
        got = np.asarray(scanner.scan(profile, staged))
        want = msv_oracle_batch(profile, tokens, lengths)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_scan_many_reuses_staging(scanner, profile_dir, fasta_dir):
    db = parse_fasta(fasta_dir / "fasta_like_example.fsa")
    staged = scanner.stage_fasta(db)
    profiles = [
        MSVProfile.from_profile(parse_hmm(profile_dir / f"{s}.hmm"))
        for s in ("100", "200")
    ]
    results = scanner.scan_many(profiles, staged)
    assert set(results) == {p.name for p in profiles}
    tokens, lengths = db.encode()
    for p in profiles:
        np.testing.assert_allclose(
            results[p.name], msv_oracle_batch(p, tokens, lengths), atol=TOL, rtol=0
        )


def test_profile_cache(scanner, profile_dir, fasta_dir):
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    staged = scanner.stage_fasta(parse_fasta(fasta_dir / "fasta_like_example.fsa"))
    scanner.scan(profile, staged)
    assert len(scanner._profile_cache) >= 1
    a = np.asarray(scanner.scan(profile, staged))
    b = np.asarray(scanner.scan(profile, staged))
    np.testing.assert_array_equal(a, b)


def test_length_bucket_parity(profile_dir, fasta_dir):
    """The staged length bucket (l_chunk) must not change scores."""
    db = parse_fasta(fasta_dir / "fasta_like_example.fsa")
    tokens, lengths = db.encode()
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    want = msv_oracle_batch(profile, tokens, lengths)
    for l_chunk in (16, 64, 1024):
        sc = MSVScanner(msv_impl="xla", l_chunk=l_chunk)
        got = np.asarray(sc.scan(profile, sc.stage(tokens, lengths)))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_bucketed_scan_matches_oracle(scanner, profile_dir):
    """Length-bucketed staging: scores identical, original order kept."""
    rng = np.random.default_rng(11)
    # heavily skewed lengths: many short, a long tail
    lengths = np.array([5, 700, 33, 64, 9, 180, 1, 640, 70, 12], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 700)).astype(np.int32)
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))

    bucketed = scanner.stage_bucketed(tokens, lengths)
    assert len(bucketed.buckets) > 1  # skew must actually split
    assert sum(s.num_sequences for s in bucketed.buckets) == len(lengths)
    got = scanner.scan_bucketed(profile, bucketed)
    want = msv_oracle_batch(profile, tokens, lengths)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert bucketed.padded_cells_saved > 0.3


def test_bucketed_single_bucket_degenerate(scanner, profile_dir):
    """Uniform lengths collapse to one bucket and still round-trip."""
    rng = np.random.default_rng(12)
    lengths = np.full(5, 96, dtype=np.int32)
    tokens = rng.integers(0, 20, size=(5, 96)).astype(np.int32)
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    bucketed = scanner.stage_bucketed(tokens, lengths)
    assert len(bucketed.buckets) == 1
    got = scanner.scan_bucketed(profile, bucketed)
    np.testing.assert_allclose(
        got, msv_oracle_batch(profile, tokens, lengths), atol=TOL, rtol=0
    )


def test_scan_p7_staged_matches_oracle(scanner, profile_dir):
    """Staged Viterbi/Forward scans (device-resident tokens)."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.reference import (
        forward_oracle_batch,
        viterbi_oracle_batch,
    )

    rng = np.random.default_rng(13)
    lengths = np.array([40, 1, 64, 17], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 64)).astype(np.int32)
    p7 = P7Profile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    staged = scanner.stage(tokens, lengths)
    got_v = np.asarray(scanner.scan_p7(p7, staged, stage="viterbi"))
    np.testing.assert_allclose(
        got_v, viterbi_oracle_batch(p7, tokens, lengths), atol=1e-4, rtol=0
    )
    got_f = np.asarray(scanner.scan_p7(p7, staged, stage="forward"))
    np.testing.assert_allclose(
        got_f, forward_oracle_batch(p7, tokens, lengths), atol=2e-3, rtol=0
    )


def test_filter_scan_is_exact(scanner, profile_dir):
    """The MSV prefilter is the exact scan (an f32 lookup costs the GPU
    what a rounded one does): trivially an upper bound, no rescore."""
    rng = np.random.default_rng(14)
    lengths = np.array([128, 40, 1, 96], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 128)).astype(np.int32)
    staged = scanner.stage(tokens, lengths)
    for stem in ("100", "300"):
        profile = MSVProfile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))
        exact = np.asarray(scanner.scan(profile, staged))
        np.testing.assert_array_equal(
            np.asarray(scanner.scan_filter(profile, staged)), exact
        )


def test_fast_msv_cascade_same_hits(profile_dir, fasta_dir):
    """fast_msv cascade must produce identical pass sets and identical
    exact scores for everything past the filter."""
    from hmm_fasta_viterbi import parse_hmm as ph
    from hmm_fasta_viterbi.io.hmmio import parse_hmm as _
    from hmm_fasta_viterbi.pipeline import SearchPipeline

    hmm = ph(profile_dir / "100.hmm")
    rng = np.random.default_rng(15)
    lengths = np.array([80, 33, 128, 5], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 128)).astype(np.int32)
    sc = MSVScanner(msv_impl="xla", l_chunk=64)
    staged = sc.stage(tokens, lengths)
    # msv_p=1.0 forces every sequence through the exact-rescore path —
    # random sequences rarely pass real thresholds, which would leave
    # the rescore (and its score writeback) untested
    slow = SearchPipeline(sc, msv_p=1.0).search(hmm, staged, tokens, lengths)
    fast = SearchPipeline(sc, msv_p=1.0, fast_msv=True).search(
        hmm, staged, tokens, lengths
    )
    idx = np.flatnonzero(slow.passed_msv)
    assert idx.size == len(lengths)  # the rescore path must actually run
    np.testing.assert_array_equal(slow.passed_msv, fast.passed_msv)
    np.testing.assert_array_equal(slow.passed_forward, fast.passed_forward)
    np.testing.assert_allclose(
        slow.msv_scores[idx], fast.msv_scores[idx], atol=1e-4, rtol=0
    )


def test_scan_many_filter_mode_upper_bound(scanner, profile_dir):
    """Stacked filter sweep dominates the exact sweep per profile."""
    rng = np.random.default_rng(16)
    lengths = np.array([96, 40, 1, 64], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 96)).astype(np.int32)
    staged = scanner.stage(tokens, lengths)
    profiles = [
        MSVProfile.from_profile(parse_hmm(profile_dir / f"{s}.hmm"))
        for s in ("100", "200")
    ]
    exact = scanner.scan_many(profiles, staged)
    approx = scanner.scan_many(profiles, staged, mode="filter")
    for p in profiles:
        assert np.all(approx[p.name] >= exact[p.name] - 1e-6)
        assert np.all(approx[p.name] - exact[p.name] < 1.0)


def test_profile_cache_id_reuse_regression(profile_dir):
    """Regression: the device-profile cache was keyed by id(profile)
    WITHOUT pinning the object — after GC, a new profile allocated at
    the recycled address silently hit the stale entry (100%-wrong
    scores, surfaced as a rare cross-test flake). Churn fresh profile
    objects through one scanner and demand oracle parity every time."""
    import gc

    sc = MSVScanner(msv_impl="xla")
    rng = np.random.default_rng(17)
    tokens = rng.integers(0, 20, size=(3, 64)).astype(np.int32)
    lengths = np.full(3, 64, dtype=np.int32)
    staged = sc.stage(tokens, lengths)
    for i in range(12):
        stem = ("100", "200")[i % 2]
        profile = MSVProfile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))
        got = np.asarray(sc.scan(profile, staged))
        want = msv_oracle_batch(profile, tokens, lengths)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        del profile
        gc.collect()


def test_profile_cache_is_bounded(profile_dir):
    """Pfam-scale sweeps iterate thousands of profiles through one
    scanner/pipeline; the pinned id-keyed caches must evict LRU instead
    of growing a device pack per profile forever (ADVICE r3)."""
    sc = MSVScanner(msv_impl="xla")
    sentinels = []
    for i in range(sc._CACHE_MAX + 40):
        obj = object()
        sentinels.append(obj)  # keep ids unique while inserting
        sc._cache_put(("k", i), obj, payload=i)
    assert len(sc._profile_cache) == sc._CACHE_MAX
    # most-recent entries survive, oldest were evicted
    assert sc._cache_get(("k", sc._CACHE_MAX + 39), sentinels[-1]) == (
        sc._CACHE_MAX + 39
    )
    assert sc._cache_get(("k", 0), sentinels[0]) is None

    from hmm_fasta_viterbi.pipeline import SearchPipeline

    pipe = SearchPipeline(sc)
    hmms = [parse_hmm(profile_dir / "100.hmm")
            for _ in range(pipe._DERIVED_MAX + 5)]
    for h in hmms:
        pipe._derived(h)
    assert len(pipe._derived_cache) == pipe._DERIVED_MAX


def test_scan_many_bucketed_matches_per_profile(scanner, profile_dir):
    """Stacked sweep over a length-bucketed ragged corpus must scatter
    scores identical to per-profile scan_bucketed (VERDICT r1 #6)."""
    from hmm_fasta_viterbi import MSVProfile, parse_hmm

    rng = np.random.default_rng(31)
    lengths = np.array([150, 7, 64, 150, 40, 99, 12, 150], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 150)).astype(np.int32)
    profiles = [
        MSVProfile.from_profile(parse_hmm(profile_dir / f"{n}.hmm"))
        for n in (100, 200)
    ]
    sc = scanner
    bucketed = sc.stage_bucketed(tokens, lengths)
    assert len(bucketed.buckets) > 1  # the ragged corpus really buckets
    stacked = sc.scan_many_bucketed(profiles, bucketed)
    for p in profiles:
        want = sc.scan_bucketed(p, bucketed)
        np.testing.assert_allclose(stacked[p.name], want, atol=0, rtol=0)


def test_stage_layout(profile_dir):
    """stage() pads to [B bucket, L bucket] int8 rows, zero past each
    length; stage_device() of the same block stages identically."""
    from hmm_fasta_viterbi.pipeline import B_BUCKET, _round_up

    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 20, size=(5, 77)).astype(np.int32)
    lengths = np.array([77, 0, 31, 1, 77], dtype=np.int32)
    sc = MSVScanner(msv_impl="xla")
    staged = sc.stage(tokens, lengths)

    b_pad, l_pad = _round_up(5, B_BUCKET), _round_up(77, sc.l_chunk)
    want = np.zeros((b_pad, l_pad), dtype=np.int8)
    want[:5, :77] = tokens
    np.testing.assert_array_equal(np.asarray(staged.tokens_i8), want)
    assert staged.num_sequences == 5
    np.testing.assert_array_equal(np.asarray(staged.lengths)[:5], lengths)

    again = sc.stage_device(staged.tokens_i8, np.asarray(staged.lengths), 5)
    profile = MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    np.testing.assert_array_equal(
        np.asarray(sc.scan(profile, again)), np.asarray(sc.scan(profile, staged))
    )
