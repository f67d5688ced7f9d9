"""Differential tests: native C++ loader vs the Python reference parsers.

Runs only when the shared library builds (g++ in the image); the Python
parsers remain the semantic oracle.
"""

import numpy as np
import pytest

from hmm_fasta_viterbi import parse_fasta, parse_hmm
from hmm_fasta_viterbi.io import loader, native

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="native fastparse not available"
)


def test_hmm_parity_all_profiles(all_profile_paths):
    for path in all_profile_paths:
        a = native.parse_hmm_native(path)
        b = parse_hmm(path)
        assert a.name == b.name
        assert a.model_length == b.model_length
        assert a.stats_local_msv_mu == pytest.approx(b.stats_local_msv_mu)
        assert a.stats_local_forward_lambda == pytest.approx(b.stats_local_forward_lambda)
        # expf vs np.exp may differ by 1 ulp; structure must be identical
        np.testing.assert_allclose(a.match_emissions, b.match_emissions, rtol=3e-7)
        np.testing.assert_allclose(a.insert_emissions, b.insert_emissions, rtol=3e-7)
        np.testing.assert_allclose(a.transitions, b.transitions, rtol=3e-7)
        assert np.all(a.match_emissions[0] == 0.0)


def test_fasta_parity(fasta_dir):
    for name in ("fasta_like_example.fsa", "random_FASTA.fsa"):
        tokens, lengths, headers, rejected = native.parse_fasta_arrays_native(
            fasta_dir / name
        )
        db = parse_fasta(fasta_dir / name)
        want_tokens, want_lengths = db.encode()
        assert lengths.tolist() == want_lengths.tolist()
        np.testing.assert_array_equal(
            tokens[:, : want_tokens.shape[1]].astype(np.int32), want_tokens
        )
        assert headers == [r.header for r in db.records]
        assert rejected == 0


def test_fasta_rejection(tmp_path):
    f = tmp_path / "mixed.fsa"
    f.write_text(">ok\nACDEF\n>bad\nACDZF\n>ok2\nGHIKL\n")
    tokens, lengths, headers, rejected = native.parse_fasta_arrays_native(f)
    assert rejected == 1
    assert headers == ["ok", "ok2"]
    assert lengths.tolist() == [5, 5]


def test_fasta_edge_cases(tmp_path):
    f = tmp_path / "edge.fsa"
    f.write_text(">empty\n>multi\nACD\n\nEF\n")
    tokens, lengths, headers, rejected = native.parse_fasta_arrays_native(f)
    assert lengths.tolist() == [0, 5]
    assert headers == ["empty", "multi"]

    bad = tmp_path / "bad.fsa"
    bad.write_text("ACDEF\n>late\nGHI\n")
    with pytest.raises(ValueError):
        native.parse_fasta_arrays_native(bad)


def test_fasta_interior_whitespace_matches_python(tmp_path):
    """Interior blanks in a sequence line reject the record in the Python
    parser (line.strip() keeps them; they are invalid symbols) — the
    native batch AND streaming readers must agree on record counts
    (ADVICE r3: they used to silently skip blanks and accept)."""
    from hmm_fasta_viterbi.io.fastaio import parse_fasta

    f = tmp_path / "blanks.fsa"
    # rec1: interior space -> reject; rec2: leading/trailing blanks only
    # -> accept (lines are stripped); rec3: interior tab -> reject
    f.write_text(">r1\nAC DEF\n>r2\n  ACDEF\t\n>r3\nAC\tDEF\n>r4\nGHIKL\n")
    db = parse_fasta(f)
    assert [r.header for r in db.records] == ["r2", "r4"]
    assert len(db.rejected) == 2

    tokens, lengths, headers, rejected = native.parse_fasta_arrays_native(f)
    assert headers == ["r2", "r4"]
    assert rejected == 2
    assert lengths.tolist() == [5, 5]

    batches = list(native.iter_fasta_batches_native(f, 8))
    assert [r.header for b in batches for r in b.records] == ["r2", "r4"]
    assert sum(b.num_rejected for b in batches) == 2


def test_hmm_error_path(tmp_path):
    f = tmp_path / "broken.hmm"
    f.write_text("NAME x\nLENG 3\n")  # missing STATS/COMPO
    with pytest.raises(ValueError):
        native.parse_hmm_native(f)
    with pytest.raises(ValueError):
        native.parse_hmm_native(tmp_path / "missing.hmm")


def test_stream_batches_match_python(tmp_path, fasta_dir):
    """Native streaming reader == Python iter_fasta_batches: batch cuts,
    headers, encoded tokens, rejection counting — across divisor and
    non-divisor batch sizes, wrapped lines, and a rejected record."""
    from hmm_fasta_viterbi.io.fastaio import iter_fasta_batches

    rng = np.random.default_rng(11)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    f = tmp_path / "stream.fsa"
    recs = []
    for i in range(9):
        seq = "".join(aas[k] for k in rng.integers(0, 20, 30 + 17 * i))
        # wrap at 25 cols to exercise multi-line joining
        seq = "\n".join(seq[j : j + 25] for j in range(0, len(seq), 25))
        recs.append(f">s{i} desc\n{seq}\n")
    recs.insert(4, ">bad\nACDZF\n")  # rejected mid-stream
    f.write_text("".join(recs))

    for bs in (1, 3, 4, 100):
        nb = list(native.iter_fasta_batches_native(f, bs))
        pb = list(iter_fasta_batches(f, bs))
        assert len(nb) == len(pb), bs
        assert sum(b.num_rejected for b in nb) == 1
        for a, b in zip(nb, pb):
            assert a.headers == [r.header for r in b.records], bs
            assert a.num_rejected == len(b.rejected)
            ta, la = a.encode(pad_multiple=8)
            tb, lb = b.encode(pad_multiple=8)
            assert np.array_equal(la, lb) and np.array_equal(ta, tb), bs

    bad = tmp_path / "bad.fsa"
    bad.write_text("ACDEF\n>late\nGHI\n")
    with pytest.raises(ValueError):
        list(native.iter_fasta_batches_native(bad, 4))
    with pytest.raises(OSError):
        list(native.iter_fasta_batches_native(tmp_path / "missing.fsa", 4))


def test_stream_fasta_loader_dispatch(fasta_dir):
    """loader.stream_fasta: native and python streams agree."""
    path = fasta_dir / "fasta_like_example.fsa"
    a = list(loader.stream_fasta(path, 2, prefer="native"))
    b = list(loader.stream_fasta(path, 2, prefer="python"))
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert [r.header for r in x.records] == [r.header for r in y.records]
        tx, lx = x.encode()
        ty, ly = y.encode()
        assert np.array_equal(tx, ty) and np.array_equal(lx, ly)


def test_stream_fasta_prefetch_matches_serial(tmp_path, fasta_dir):
    """Background-prefetch streaming == serial streaming: same batches,
    same encoded tokens; worker exceptions surface in the consumer."""
    path = fasta_dir / "fasta_like_example.fsa"
    for prefer in ("native", "python"):
        serial = list(loader.stream_fasta(path, 2, prefer=prefer))
        pre = list(loader.stream_fasta_prefetch(path, 2, prefer=prefer))
        assert [len(b) for b in pre] == [len(b) for b in serial]
        enc = list(loader.stream_fasta_prefetch(
            path, 2, prefer=prefer, encode_pad_multiple=8
        ))
        for (b, tok, lens), sb in zip(enc, serial):
            st, sl = sb.encode(pad_multiple=8)
            np.testing.assert_array_equal(tok, st)
            np.testing.assert_array_equal(lens, sl)
            assert [r.header for r in b.records] == [
                r.header for r in sb.records
            ]
    bad = tmp_path / "bad.fsa"
    bad.write_text("ACDEF\n>late\nGHI\n")  # data before first header
    with pytest.raises(Exception):
        list(loader.stream_fasta_prefetch(bad, 4, prefer="python"))
    # abandoning the generator mid-stream must not deadlock the worker
    gen = loader.stream_fasta_prefetch(path, 1, prefer="python")
    next(gen)
    gen.close()


def test_stream_fasta_prefetch_staged_int8(fasta_dir):
    """With a stage_fn the prefetch loader encodes tokens as int8 (the
    kernel layout — the int32 detour was 4x the producer-thread memory
    traffic); values must equal the int32 path's exactly, and the
    staged object must round-trip through the real scanner.stage."""
    from hmm_fasta_viterbi.pipeline import MSVScanner

    path = fasta_dir / "fasta_like_example.fsa"
    sc = MSVScanner(msv_impl="xla")
    for prefer in ("native", "python"):
        plain = list(loader.stream_fasta_prefetch(
            path, 2, prefer=prefer, encode_pad_multiple=8
        ))
        staged_stream = list(loader.stream_fasta_prefetch(
            path, 2, prefer=prefer, encode_pad_multiple=8,
            stage_fn=sc.stage,
        ))
        assert len(staged_stream) == len(plain)
        for (b, tok, lens, staged), (_, tok32, lens32) in zip(
            staged_stream, plain
        ):
            assert tok.dtype == np.int8
            assert tok32.dtype == np.int32
            np.testing.assert_array_equal(tok.astype(np.int32), tok32)
            np.testing.assert_array_equal(lens, lens32)
            assert staged.num_sequences == len(b)
            # survivor-rescore path: re-staging an int8 subset must
            # produce the same device block as staging the int32 rows
            sub8 = sc.stage(tok[:1], lens[:1])
            sub32 = sc.stage(tok32[:1], lens32[:1])
            np.testing.assert_array_equal(
                np.asarray(sub8.tokens_i8), np.asarray(sub32.tokens_i8)
            )


def test_loader_prefer_modes(profile_dir, fasta_dir):
    a = loader.load_profile(profile_dir / "100.hmm", prefer="native")
    b = loader.load_profile(profile_dir / "100.hmm", prefer="python")
    np.testing.assert_allclose(a.match_emissions, b.match_emissions, rtol=3e-7)
    tokens, lengths, headers = loader.load_fasta_arrays(
        fasta_dir / "fasta_like_example.fsa", prefer="native"
    )
    assert len(headers) == 4 and lengths.tolist() == [18, 18, 15, 130]


def test_native_stale_abi_rebuilds(tmp_path, monkeypatch):
    """A stale-ABI libfastparse.so must trigger one rebuild, not disable
    the native loader for the process lifetime (round-3 review)."""
    import shutil
    import subprocess

    from hmm_fasta_viterbi.io import native

    try:
        native._load()
    except native.NativeUnavailable:
        pytest.skip("native library unavailable")
    real_path = native._LIB_PATH
    stub_src = tmp_path / "stub.c"
    stub_src.write_text("int fp_abi_version(void){return -1;}\n")
    stub = tmp_path / "libfastparse.so"
    subprocess.run(
        ["cc", "-shared", "-fPIC", "-o", str(stub), str(stub_src)],
        check=True,
    )
    calls = []

    def fake_build():
        calls.append(1)
        shutil.copy(real_path, stub)
        return True

    monkeypatch.setattr(native, "_LIB_PATH", stub)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "_build", fake_build)
    lib = native._load()
    assert calls == [1]  # exactly one rebuild attempt
    assert lib.fp_abi_version() == native._ABI_VERSION


def test_native_stream_warns_on_rejects(tmp_path, caplog):
    """The native streaming reader must surface rejected sequences with
    a warning (reference reject-with-warning semantics), not silently
    drop them (round-3 review)."""
    import logging

    from hmm_fasta_viterbi.io import native

    if not native.native_available():
        pytest.skip("native library unavailable")
    f = tmp_path / "rej.fsa"
    f.write_text(">ok\nACDEF\n>bad\nACDZF\n>ok2\nGHIKL\n")
    with caplog.at_level(logging.WARNING, logger="hmm_fasta_viterbi.io.native"):
        batches = list(native.iter_fasta_batches_native(f, 10))
    assert sum(len(b) for b in batches) == 2
    assert sum(b.num_rejected for b in batches) == 1
    assert any("rejected 1" in r.message for r in caplog.records)
    # whole-file native parse warns too
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="hmm_fasta_viterbi.io.native"):
        db = native.parse_fasta_native(f)
    assert len(db) == 2
    assert any("rejected 1" in r.message for r in caplog.records)


def test_native_multi_hmm_matches_python(tmp_path, profile_dir):
    """fp_parse_hmm_buf over a concatenated database == the Python
    parse_hmm_multi, model for model, over all 24 fixtures (incl. the
    no-trailing-newline '//HMMER3/b' concatenation seam)."""
    from hmm_fasta_viterbi.io import native
    from hmm_fasta_viterbi.io.hmmio import parse_hmm_multi

    if not native.native_available():
        pytest.skip("native library unavailable")
    db = tmp_path / "all.hmm"
    parts = [p.read_text() for p in sorted(profile_dir.glob("*.hmm"))]
    db.write_text("".join(parts))
    got = native.parse_hmm_multi_native(db)
    want = parse_hmm_multi(db)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert g.name == w.name and g.model_length == w.model_length
        np.testing.assert_allclose(
            g.match_emissions, w.match_emissions, rtol=3e-7
        )
        np.testing.assert_allclose(g.transitions, w.transitions, rtol=3e-7)
        assert g.stats_local_msv_mu == w.stats_local_msv_mu
    # malformed record mid-database reports its ordinal
    bad = tmp_path / "bad.hmm"
    bad.write_text(parts[0] + "HMMER3/b\nNAME broken\nLENG 5\n//\n" + parts[1])
    with pytest.raises(ValueError, match="model 2"):
        native.parse_hmm_multi_native(bad)
