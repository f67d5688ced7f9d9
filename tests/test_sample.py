"""Core-model sampling (models.sample, the `emit` subcommand).

The strongest correctness check for a generative sampler is
discriminative: sequences drawn FROM the profile must score as
overwhelmingly significant when scanned BY the profile, while random
sequences do not (that contrast is the whole point of the scan engine).
"""

import json

import numpy as np
import pytest

from hmm_fasta_viterbi.cli import main
from hmm_fasta_viterbi.io.hmmio import parse_hmm
from hmm_fasta_viterbi.models import stats
from hmm_fasta_viterbi.models.p7 import P7Profile
from hmm_fasta_viterbi.models.sample import sample_sequences
from hmm_fasta_viterbi.ops.p7_scan import forward_xla


def test_samples_deterministic_and_shaped(profile_dir):
    hmm = parse_hmm(profile_dir / "100.hmm", star_as_zero_prob=True)
    toks = sample_sequences(hmm, 16, seed=7)
    again = sample_sequences(hmm, 16, seed=7)
    assert all(np.array_equal(a, b) for a, b in zip(toks, again))
    assert all(t.dtype == np.int32 and (t >= 0).all() and (t < 20).all()
               for t in toks)
    lens = np.array([len(t) for t in toks])
    # LENG=100 core model: samples hover around the model length
    # (deletions shorten, insert loops lengthen)
    assert 40 <= np.median(lens) <= 300, lens


def test_samples_score_significant(profile_dir):
    hmm = parse_hmm(profile_dir / "100.hmm", star_as_zero_prob=True)
    toks = sample_sequences(hmm, 12, seed=3)
    lens = np.array([len(t) for t in toks], dtype=np.int32)
    batch = np.zeros((len(toks), int(lens.max())), dtype=np.int32)
    for i, t in enumerate(toks):
        batch[i, : len(t)] = t
    # score with the reference-quirk parse (the scan engine's numerics)
    p7 = P7Profile.from_profile(parse_hmm(profile_dir / "100.hmm"))
    pv = stats.forward_pvalue(np.asarray(forward_xla(p7, batch, lens)), hmm)
    assert np.median(pv) < 1e-6, pv
    # contrast: uniform-random sequences of the same lengths are not
    rng = np.random.default_rng(0)
    rnd = np.zeros_like(batch)
    for i, l in enumerate(lens):
        rnd[i, :l] = rng.integers(0, 20, int(l))
    pv_rnd = stats.forward_pvalue(
        np.asarray(forward_xla(p7, rnd, lens)), hmm
    )
    assert np.median(pv_rnd) > 1e-3, pv_rnd


def test_cli_emit(tmp_path, profile_dir, capsys):
    args = ["emit", "--hmm", str(profile_dir / "100.hmm"),
            "--count", "3", "--seed", "1"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert out.count(">") == 3 and "sample1" in out
    # deterministic per seed
    assert main(args) == 0
    assert capsys.readouterr().out == out
    # consensus mode + file output feed straight back into scan
    fasta = tmp_path / "emitted.fsa"
    assert main(["emit", "--hmm", str(profile_dir / "100.hmm"),
                 "--consensus", "--out", str(fasta)]) == 0
    capsys.readouterr()
    assert main(["scan", "--hmm", str(profile_dir / "100.hmm"),
                 "--fasta", str(fasta), "--msv-impl", "xla",
                 "--stage", "search", "--format", "json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows and rows[0]["hit"]
