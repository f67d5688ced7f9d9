"""Multi-device tests on the virtual 8-device CPU mesh.

Validates the two net-new scaling axes (SURVEY.md §5/§7): database
sharding over ``db`` and the long-sequence wavefront pipeline over ``sp``
— both differentially against the single-device oracle.
"""

import os
import pathlib

import jax
import numpy as np
import pytest

from hmm_fasta_viterbi import MSVProfile, msv_oracle_batch, parse_hmm
from hmm_fasta_viterbi.parallel.database import msv_scan_sharded, top_k_hits
from hmm_fasta_viterbi.parallel.mesh import make_scan_mesh
from hmm_fasta_viterbi.parallel.seqblocks import msv_scan_seqblocks

TOL = 1e-4


@pytest.fixture(scope="module")
def profile(profile_dir):
    return MSVProfile.from_profile(parse_hmm(profile_dir / "100.hmm"))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    lengths = np.array([64, 100, 1, 77, 128, 55, 9, 100, 31, 2], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 128)).astype(np.int32)
    return tokens, lengths


def test_eight_devices_available():
    assert jax.device_count() == 8


def test_database_sharded_scan(profile, batch):
    tokens, lengths = batch
    mesh = make_scan_mesh(db=8, sp=1)
    got = msv_scan_sharded(profile, tokens, lengths, mesh)
    want = msv_oracle_batch(profile, tokens, lengths)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_seqblock_wavefront(profile, batch):
    """Residue blocks across 4 devices x db across 2: boundary-carry parity."""
    tokens, lengths = batch
    mesh = make_scan_mesh(db=2, sp=4)
    got = msv_scan_seqblocks(profile, tokens, lengths, mesh)
    want = msv_oracle_batch(profile, tokens, lengths)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_seqblock_pure_sp(profile, batch):
    """All 8 devices on the sequence axis (single very long stream case)."""
    tokens, lengths = batch
    mesh = make_scan_mesh(db=1, sp=8)
    got = msv_scan_seqblocks(profile, tokens, lengths, mesh)
    want = msv_oracle_batch(profile, tokens, lengths)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_seqblock_long_sequence(profile):
    """One 4096-residue sequence split across 8 devices."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 20, size=(1, 4096)).astype(np.int32)
    lengths = np.array([4096], dtype=np.int32)
    mesh = make_scan_mesh(db=1, sp=8)
    got = msv_scan_seqblocks(profile, tokens, lengths, mesh)
    want = msv_oracle_batch(profile, tokens, lengths)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_seqblock_ragged_vs_block_boundaries(profile):
    """Lengths that end exactly at / just past shard boundaries."""
    mesh = make_scan_mesh(db=1, sp=4)
    rng = np.random.default_rng(13)
    L = 64  # per-shard block = 16
    lengths = np.array([16, 17, 15, 32, 48, 64, 63, 1], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), L)).astype(np.int32)
    got = msv_scan_seqblocks(profile, tokens, lengths, mesh)
    want = msv_oracle_batch(profile, tokens, lengths)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_top_k(profile, batch):
    tokens, lengths = batch
    mesh = make_scan_mesh(db=8, sp=1)
    scores = msv_scan_sharded(profile, tokens, lengths, mesh)
    vals, idx = top_k_hits(jax.numpy.asarray(scores), k=3)
    order = np.argsort(scores)[::-1][:3]
    np.testing.assert_array_equal(np.asarray(idx), order)
    np.testing.assert_allclose(np.asarray(vals), scores[order], atol=0)


def test_seqblock_group_sizes(profile, batch):
    """Row-group microbatching must not change scores."""
    tokens, lengths = batch
    mesh = make_scan_mesh(db=2, sp=4)
    want = msv_oracle_batch(profile, tokens, lengths)
    for group in (1, 2, 8):
        got = msv_scan_seqblocks(profile, tokens, lengths, mesh, group=group)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_sharded_db_scan(profile, batch):
    """shard_map'd MSV scan (the XLA implementation per device) over the
    db axis, on the staged layout."""
    from hmm_fasta_viterbi.parallel.database import make_db_scanner
    from hmm_fasta_viterbi.pipeline import MSVScanner

    tokens, lengths = batch
    mesh = make_scan_mesh(db=8, sp=1)
    scanner = MSVScanner(msv_impl="xla", l_chunk=64, mesh=mesh)
    staged = scanner.stage(tokens, lengths)
    assert staged.tokens_i8.shape[0] % (8 * 128) == 0
    assert len(staged.tokens_i8.sharding.device_set) == 8
    got = np.asarray(scanner.scan(profile, staged))
    table, consts = scanner._cache_get((id(profile), "msv"), profile)
    fn = make_db_scanner(mesh, "xla")
    direct = np.asarray(
        fn(table, staged.tokens_i8, staged.lengths, staged.tr_rows, consts)
    )[0, : len(lengths)]
    want = msv_oracle_batch(profile, tokens, lengths)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(direct, got)


@pytest.mark.parametrize("stage", ["viterbi", "forward"])
def test_mesh_scan_p7(batch, profile_dir, stage):
    """The Viterbi / Forward stages shard over the db axis too."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.reference import (
        forward_oracle_batch,
        viterbi_oracle_batch,
    )
    from hmm_fasta_viterbi.pipeline import MSVScanner

    tokens, lengths = batch
    p7 = P7Profile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    sc = MSVScanner(msv_impl="xla", l_chunk=64, mesh=make_scan_mesh(db=4, sp=1))
    got = np.asarray(sc.scan_p7(p7, sc.stage(tokens, lengths), stage=stage))
    oracle = viterbi_oracle_batch if stage == "viterbi" else forward_oracle_batch
    tol = 1e-4 if stage == "viterbi" else 2e-3
    rows = np.arange(4)
    np.testing.assert_allclose(
        got[rows], oracle(p7, tokens[rows], lengths[rows]), atol=tol, rtol=0
    )


def test_multihost_two_process_smoke():
    """Real jax.distributed: 2 processes x 4 virtual CPU devices run the
    SAME jitted scan program; scores match the oracle (tools/
    multihost_smoke.py). This is the multi-host claim, tested."""
    import socket
    import subprocess
    import sys as _sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    script = repo / "tools" / "multihost_smoke.py"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the smoke sets its own device count

    def attempt():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [
            subprocess.Popen(
                [_sys.executable, str(script), str(i), "2", str(port)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                env=env,
                text=True,
            )
            for i in range(2)
        ]
        outs = []
        ok = True
        for p in procs:
            try:
                outs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:  # hung handshake: kill, retry
                p.kill()
                outs.append(p.communicate()[0] + "\n<timed out>")
                ok = False
        ok = ok and all(
            p.returncode == 0 and "MULTIHOST_OK" in out
            for p, out in zip(procs, outs)
        )
        return ok, outs

    ok, outs = attempt()
    if not ok:  # coordinator handshakes can race under load; retry once
        ok, outs = attempt()
    assert ok, outs[0][-2000:] + outs[1][-2000:]


def test_mesh_scanner_full_cascade_vs_oracle(batch, profile_dir):
    """A mesh-carrying MSVScanner shards EVERY cascade stage over the db
    axis: MSV exact + filter, Viterbi exact + filter, Forward — all vs
    single-device oracles on the 8-device CPU mesh."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.ops.reference import (
        forward_oracle_batch,
        viterbi_oracle_batch,
    )
    from hmm_fasta_viterbi.pipeline import MSVScanner

    tokens, lengths = batch
    hmm = parse_hmm(profile_dir / "100.hmm")
    msv = MSVProfile.from_profile(hmm)
    p7 = P7Profile.from_profile(hmm)
    mesh = make_scan_mesh(db=8, sp=1)
    sc = MSVScanner(msv_impl="xla", l_chunk=64, mesh=mesh)
    staged = sc.stage(tokens, lengths)
    assert staged.lengths.shape[0] % (8 * 128) == 0

    got = np.asarray(sc.scan(msv, staged))
    np.testing.assert_allclose(
        got, msv_oracle_batch(msv, tokens, lengths), atol=TOL, rtol=0
    )
    filt = np.asarray(sc.scan_filter(msv, staged))
    assert np.all(filt >= got - 1e-6)

    vit = np.asarray(sc.scan_p7(p7, staged, stage="viterbi"))
    np.testing.assert_allclose(
        vit, viterbi_oracle_batch(p7, tokens, lengths), atol=TOL, rtol=0
    )
    vfilt = np.asarray(sc.scan_p7_filter(p7, staged))
    assert np.all(vfilt >= vit - 1e-6)

    fwd = np.asarray(sc.scan_p7(p7, staged, stage="forward"))
    np.testing.assert_allclose(
        fwd, forward_oracle_batch(p7, tokens, lengths), atol=2e-3, rtol=0
    )


def test_mesh_scan_many_stacked(batch, profile_dir):
    """The stacked multi-profile sweep under shard_map matches
    per-profile oracle scores."""
    from hmm_fasta_viterbi.pipeline import MSVScanner

    tokens, lengths = batch
    profiles = [
        MSVProfile.from_profile(parse_hmm(profile_dir / f"{n}.hmm"))
        for n in (100, 200)
    ]
    mesh = make_scan_mesh(db=8, sp=1)
    sc = MSVScanner(msv_impl="xla", l_chunk=64, mesh=mesh)
    staged = sc.stage(tokens, lengths)
    results = sc.scan_many(profiles, staged)
    for p in profiles:
        want = msv_oracle_batch(p, tokens, lengths)
        np.testing.assert_allclose(results[p.name], want, atol=TOL, rtol=0)


def test_mesh_search_pipeline_matches_single_device(profile_dir):
    """SearchPipeline over a mesh scanner: same hits + scores as the
    single-device pipeline (consensus sequence must hit)."""
    from hmm_fasta_viterbi.io.alphabet import AMINO_ACIDS, encode_sequence
    from hmm_fasta_viterbi.pipeline import MSVScanner, SearchPipeline

    hmm = parse_hmm(profile_dir / "100.hmm")
    best = np.argmax(hmm.match_emissions[1:], axis=1)
    cons = "".join(AMINO_ACIDS[i] for i in best)
    rng = np.random.default_rng(3)
    seq_len = max(len(cons), 120)
    tokens = rng.integers(0, 20, size=(4, seq_len)).astype(np.int32)
    lengths = np.full(4, seq_len, dtype=np.int32)
    tokens[1, : len(cons)] = encode_sequence(cons)
    lengths[1] = len(cons)

    mesh = make_scan_mesh(db=8, sp=1)
    sc_mesh = MSVScanner(msv_impl="xla", l_chunk=64, mesh=mesh)
    sc_one = MSVScanner(msv_impl="xla", l_chunk=64)
    res_mesh = SearchPipeline(
        sc_mesh, fast_msv=True, fast_viterbi=True
    ).search(hmm, sc_mesh.stage(tokens, lengths), tokens, lengths)
    res_one = SearchPipeline(sc_one).search(
        hmm, sc_one.stage(tokens, lengths), tokens, lengths
    )
    assert res_mesh.hits.tolist() == res_one.hits.tolist() == [1]
    for h in res_mesh.hits:
        assert res_mesh.viterbi_scores[h] == pytest.approx(
            res_one.viterbi_scores[h], abs=1e-4
        )
        assert res_mesh.forward_scores[h] == pytest.approx(
            res_one.forward_scores[h], abs=2e-3
        )


def test_seqblock_scanner_refuses_p7(profile_dir):
    """The Viterbi / Forward stages have no sequence-parallel wavefront:
    the sp scanner refuses them instead of scoring them another way."""
    from hmm_fasta_viterbi.models.p7 import P7Profile
    from hmm_fasta_viterbi.parallel.seqblocks import SeqblockScanner

    p7 = P7Profile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    sb = SeqblockScanner(make_scan_mesh(db=2, sp=4))
    staged = sb.stage(np.zeros((2, 16), np.int32), np.array([16, 3], np.int32))
    for stage in ("viterbi", "forward"):
        with pytest.raises(ValueError, match="wavefront"):
            sb.scan_p7(p7, staged, stage=stage)


def test_sp_msv_matches_single_device(profile_dir):
    """The sp scanner's MSV stage (wavefront over a db x sp mesh) gives
    the single-device scanner's scores, sweep included."""
    from hmm_fasta_viterbi.parallel.seqblocks import SeqblockScanner
    from hmm_fasta_viterbi.pipeline import MSVScanner

    from conftest import consensus_tokens

    hmm = parse_hmm(profile_dir / "100.hmm")
    rng = np.random.default_rng(37)
    hit = consensus_tokens(hmm)
    L = 192
    lengths = np.array([len(hit), 50, 173, 192, 1, 128], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), L)).astype(np.int32)
    tokens[0, : len(hit)] = hit
    profiles = [
        MSVProfile.from_profile(parse_hmm(profile_dir / f"{n}.hmm"))
        for n in (100, 200)
    ]

    sb = SeqblockScanner(make_scan_mesh(db=2, sp=4))
    one = MSVScanner(msv_impl="xla")
    got = sb.scan_many(profiles, sb.stage(tokens, lengths))
    want = one.scan_many(profiles, one.stage(tokens, lengths))
    for p in profiles:
        np.testing.assert_allclose(got[p.name], want[p.name], atol=1e-4, rtol=0)
