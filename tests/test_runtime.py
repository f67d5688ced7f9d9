"""Runtime subsystem tests: config, checkpoint/resume, profiling."""

import json

import numpy as np
import pytest

from hmm_fasta_viterbi import MSVProfile, msv_oracle_batch, parse_hmm
from hmm_fasta_viterbi.pipeline import MSVScanner
from hmm_fasta_viterbi.runtime.checkpoint import ScanCheckpoint, resumable_sweep
from hmm_fasta_viterbi.runtime.config import EngineConfig
from hmm_fasta_viterbi.runtime.profiling import SectionTimer


def test_config_roundtrip(tmp_path):
    cfg = EngineConfig(msv_impl="xla", l_chunk=128, mesh_db=4, mesh_sp=2)
    path = tmp_path / "cfg.json"
    cfg.to_json(path)
    again = EngineConfig.from_json(path)
    assert again == cfg


def test_config_rejects_unknown(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"msv_impl": "xla", "bogus": 1}))
    with pytest.raises(ValueError, match="bogus"):
        EngineConfig.from_json(path)


def test_config_from_env():
    env = {"HFV_MSV_IMPL": "cuda", "HFV_L_CHUNK": "256", "HFV_MESH_DB": "none",
           "HFV_MSV_P": "0.05"}
    cfg = EngineConfig.from_env(env)
    assert cfg.msv_impl == "cuda"
    assert cfg.l_chunk == 256
    assert cfg.mesh_db is None
    assert cfg.msv_p == 0.05


def test_resumable_sweep(tmp_path, profile_dir):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 20, size=(10, 64)).astype(np.int32)
    lengths = np.full(10, 64, dtype=np.int32)
    profiles = [
        MSVProfile.from_profile(parse_hmm(profile_dir / s))
        for s in ("100.hmm", "200.hmm")
    ]
    scanner = MSVScanner(msv_impl="xla")
    ckpt = ScanCheckpoint(tmp_path / "ckpt")

    res1 = resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=4)
    for p in profiles:
        want = msv_oracle_batch(p, tokens, lengths)
        np.testing.assert_allclose(res1[p.name], want, atol=1e-4, rtol=0)

    # resume: all shards cached -> identical results without rescanning
    class Boom:
        def stage(self, *a, **k):
            raise AssertionError("resume must not rescan")

    res2 = resumable_sweep(Boom(), profiles, tokens, lengths, ckpt, shard_size=4)
    for p in profiles:
        np.testing.assert_array_equal(res1[p.name], res2[p.name])


def test_resumable_sweep_stages_each_shard_once(tmp_path, profile_dir):
    """Round-3 staging economics: N profiles x S shards must stage S
    times (shard-outer, stacked scan_many), not N x S (the round-2
    quadratic re-upload)."""
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 20, size=(9, 48)).astype(np.int32)
    lengths = np.full(9, 48, dtype=np.int32)
    profiles = [
        MSVProfile.from_profile(parse_hmm(profile_dir / s))
        for s in ("100.hmm", "200.hmm", "300.hmm")
    ]

    class CountingScanner(MSVScanner):
        stage_calls = 0

        def stage(self, *a, **k):
            CountingScanner.stage_calls += 1
            return super().stage(*a, **k)

    scanner = CountingScanner(msv_impl="xla")
    ckpt = ScanCheckpoint(tmp_path / "ckpt")
    res = resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=4)
    assert CountingScanner.stage_calls == 3  # ceil(9/4) shards, once each
    for p in profiles:
        want = msv_oracle_batch(p, tokens, lengths)
        np.testing.assert_allclose(res[p.name], want, atol=1e-4, rtol=0)

    # partial resume: drop ONE (profile, shard) chunk; the rerun must
    # restage only that shard and rescan only that profile
    ckpt._chunk_path(profiles[1].name, 1).unlink()
    CountingScanner.stage_calls = 0
    scanned = []
    orig = CountingScanner.scan_many

    def tracking_scan_many(self, ps, staged, **k):
        scanned.extend(p.name for p in ps)
        return orig(self, ps, staged, **k)

    CountingScanner.scan_many = tracking_scan_many
    try:
        res2 = resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=4)
    finally:
        CountingScanner.scan_many = orig
    assert CountingScanner.stage_calls == 1
    assert scanned == [profiles[1].name]
    for p in profiles:
        np.testing.assert_array_equal(res[p.name], res2[p.name])


def test_resumable_search_sweep(tmp_path, profile_dir):
    from hmm_fasta_viterbi.pipeline import SearchPipeline
    from hmm_fasta_viterbi.runtime.checkpoint import (
        resumable_search_sweep,
    )

    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 20, size=(6, 64)).astype(np.int32)
    lengths = np.full(6, 64, dtype=np.int32)
    hmms = [parse_hmm(profile_dir / s) for s in ("100.hmm", "200.hmm")]
    pipeline = SearchPipeline(MSVScanner(msv_impl="xla"), msv_p=0.9,
                              viterbi_p=0.9, forward_p=0.9)
    ckpt = ScanCheckpoint(tmp_path / "sckpt")
    res1 = resumable_search_sweep(
        pipeline, hmms, tokens, lengths, ckpt, shard_size=4
    )
    # matches the unsharded cascade
    staged = pipeline.scanner.stage(tokens, lengths)
    for hmm in hmms:
        direct = pipeline.search(hmm, staged, tokens, lengths)
        got = res1[hmm.name]
        np.testing.assert_allclose(
            got.msv_scores, direct.msv_scores, atol=1e-4, rtol=0
        )
        np.testing.assert_array_equal(got.passed_forward, direct.passed_forward)

    # kill-and-rerun: a completed checkpoint must not rescan anything
    class BoomPipeline:
        class scanner:  # noqa: N801 - attribute shim
            @staticmethod
            def stage(*a, **k):
                raise AssertionError("resume must not rescan")

    res2 = resumable_search_sweep(
        BoomPipeline(), hmms, tokens, lengths, ckpt, shard_size=4
    )
    for hmm in hmms:
        np.testing.assert_array_equal(
            res1[hmm.name].forward_scores, res2[hmm.name].forward_scores
        )


def test_resume_partition_mismatch(tmp_path, profile_dir):
    tokens = np.zeros((4, 8), dtype=np.int32)
    lengths = np.full(4, 8, dtype=np.int32)
    profiles = [MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))]
    scanner = MSVScanner(msv_impl="xla")
    ckpt = ScanCheckpoint(tmp_path / "ckpt")
    resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=2)
    with pytest.raises(ValueError, match="different partition"):
        resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=3)


def test_section_timer():
    t = SectionTimer()
    with t.section("a"):
        pass
    with t.section("b"):
        pass
    report = t.report()
    assert "a=" in report and "b=" in report


def test_bench_json_line_schema():
    """The driver-facing bench line carries per-rep seconds and an
    environment fingerprint (run-to-run variance must be attributable
    from the artifact alone)."""
    from hmm_fasta_viterbi.bench.harness import BenchResult, emit_json_line

    r = BenchResult(
        name="unit", gcups=1.0, seconds=0.5, cells=500_000_000, batch=4,
        seq_len=100, model_length=101, repetitions=2,
        rep_seconds=[0.6, 0.5],
    )
    payload = json.loads(emit_json_line(r, [r], errors=["x failed"]))
    assert payload["unit"] == "GCUPS"
    detail = payload["detail"]
    assert detail["primary"]["rep_seconds"] == [0.6, 0.5]
    assert detail["errors"] == ["x failed"]
    env = detail["env"]
    assert "timestamp_utc" in env and "hostname" in env
    # device probe is best-effort: either a resolved platform or an error
    assert ("platform" in env) or ("device_error" in env)


def test_resume_legacy_manifest(tmp_path, profile_dir):
    """Manifests written before the search sweep existed carry no 'kind'
    key; resuming such an msv-sweep checkpoint must keep working (round-3
    review fix: the kind check treated legacy manifests as a partition
    mismatch)."""
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 20, size=(8, 48)).astype(np.int32)
    lengths = np.full(8, 48, dtype=np.int32)
    profiles = [MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))]
    scanner = MSVScanner(msv_impl="xla")
    ckpt = ScanCheckpoint(tmp_path / "ckpt")
    res1 = resumable_sweep(scanner, profiles, tokens, lengths, ckpt, shard_size=4)

    # strip 'kind' to simulate a pre-round-3 manifest, then resume
    m = ckpt.read_manifest()
    del m["kind"]
    ckpt.write_manifest(m)

    class Boom:
        def stage(self, *a, **k):
            raise AssertionError("resume must not rescan")

    res2 = resumable_sweep(Boom(), profiles, tokens, lengths, ckpt, shard_size=4)
    np.testing.assert_array_equal(res1["Pfam-B_229"], res2["Pfam-B_229"])


def test_compile_cache_default_dir(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is <repo>/.jax_cache —
    a fixed path, so the next process finds what this one compiled."""
    import jax

    from hmm_fasta_viterbi.runtime.cache import REPO, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing else
    is configured (JAX reads the variable itself)."""
    import jax

    from hmm_fasta_viterbi.runtime.cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
