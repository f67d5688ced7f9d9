"""The CUDA MSV kernel's surroundings (ops.msv_cuda) and the choice of
MSV implementation per platform.

The kernel itself runs only on a CUDA device (``gpu``-marked tests
below). On the CPU these tests hold what feeds it to the NumPy oracle:
the states-per-lane choice, the lane-interleaved table, stacked profiles
and padding, through msv_packed_reference — the plain-JAX reading of
exactly the kernel's operands — and through the scanner's CUDA branch
with that reference standing in for the kernel.
"""

import numpy as np
import pytest

from hmm_fasta_viterbi import MSVProfile, msv_oracle_batch, parse_fasta, parse_hmm
from hmm_fasta_viterbi.models.msv import length_transitions
from hmm_fasta_viterbi.ops import msv_cuda
from hmm_fasta_viterbi.pipeline import MSVScanner, resolve_msv_impl

TOL = 1e-4


def _load(profile_dir, stem):
    return MSVProfile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))


def _operands(profiles, tokens, lengths, q=None):
    """The kernel's operands for a profile stack and a token batch."""
    import jax.numpy as jnp

    q = q or max(msv_cuda.states_per_lane(p.num_states) for p in profiles)
    table = np.stack([msv_cuda.pack_table(p.scores_real, q) for p in profiles])
    l_pad = -(-tokens.shape[1] // msv_cuda.L_MULTIPLE) * msv_cuda.L_MULTIPLE
    tok = np.zeros((tokens.shape[0], l_pad), dtype=np.int8)
    tok[:, : tokens.shape[1]] = tokens
    tr_loop, tr_move = length_transitions(lengths)
    consts = np.array(
        [[p.tr_B_Mk, p.tr_E_C, p.tr_E_J] for p in profiles], dtype=np.float32
    )
    return (
        jnp.asarray(table), jnp.asarray(tok), jnp.asarray(lengths),
        jnp.asarray(np.stack([tr_loop, tr_move])), jnp.asarray(consts),
    )


def _ragged_batch(seed=5, width=130):
    rng = np.random.default_rng(seed)
    lengths = np.array([64, 100, 1, 77, width, 0, 55, 9], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), width)).astype(np.int32)
    return tokens, lengths


@pytest.mark.parametrize(
    "states,q",
    [(1, 4), (100, 4), (128, 4), (129, 8), (1001, 32), (1400, 44),
     (2405, 76), (2560, 80), (2561, 84)],
)
def test_states_per_lane(states, q):
    """32 lanes x q states cover the profile; q is a multiple of 4 (the
    float4 table loads); the kernels are compiled up to Q_MAX = 80."""
    assert msv_cuda.states_per_lane(states) == q
    assert (q <= msv_cuda.Q_MAX) == (states <= 2560)


@pytest.mark.parametrize("stem", ["100", "1001", "2405"])
def test_pack_table_lane_interleaved(profile_dir, stem):
    """Element [a, (k4*32 + lane)*4 + r] is state lane*q + 4*k4 + r; pad
    states are -inf; unpack_table inverts the layout."""
    p = _load(profile_dir, stem)
    q = msv_cuda.states_per_lane(p.num_states)
    table = msv_cuda.pack_table(p.scores_real, q)
    assert table.shape == (20, 32 * q) and table.dtype == np.float32
    for lane, k4, r in ((0, 0, 0), (31, q // 4 - 1, 3), (7, q // 8, 2)):
        state = lane * q + 4 * k4 + r
        want = p.scores_real[:, state] if state < p.num_states else -np.inf
        np.testing.assert_array_equal(table[:, (k4 * 32 + lane) * 4 + r], want)
    plain = np.asarray(msv_cuda.unpack_table(table[None]))[0]
    np.testing.assert_array_equal(plain[:, : p.num_states], p.scores_real)
    assert np.isneginf(plain[:, p.num_states:]).all()


@pytest.mark.parametrize("stem", ["100", "200", "1001", "1400"])
def test_packed_reference_vs_oracle(profile_dir, stem):
    """The kernel's operands, read by the plain-JAX reference, score the
    oracle's numbers on a ragged batch (empty rows -inf)."""
    p = _load(profile_dir, stem)
    tokens, lengths = _ragged_batch()
    got = np.asarray(msv_cuda.msv_packed_reference(*_operands([p], tokens, lengths)))
    assert got.shape == (1, len(lengths))
    want = msv_oracle_batch(p, tokens, lengths)
    mask = lengths > 0
    np.testing.assert_allclose(got[0, mask], want[mask], atol=TOL, rtol=0)
    assert np.isneginf(got[0, ~mask]).all()


def test_stacked_profiles(profile_dir, fasta_dir):
    """One call scores a stack of profiles padded to one width."""
    db = parse_fasta(fasta_dir / "fasta_like_example.fsa")
    tokens, lengths = db.encode(pad_multiple=8)
    profiles = [_load(profile_dir, s) for s in ("100", "200", "300")]
    got = np.asarray(
        msv_cuda.msv_packed_reference(*_operands(profiles, tokens, lengths))
    )
    assert got.shape == (3, tokens.shape[0])
    for k, p in enumerate(profiles):
        np.testing.assert_allclose(
            got[k], msv_oracle_batch(p, tokens, lengths), atol=TOL, rtol=0
        )


def test_wider_packing_is_invisible(profile_dir):
    """Padding the table past a profile's own q (the stacked sweep pads
    every profile of a group to the widest) leaves scores bit-identical."""
    p = _load(profile_dir, "100")
    tokens, lengths = _ragged_batch(seed=6)
    narrow = np.asarray(msv_cuda.msv_packed_reference(*_operands([p], tokens, lengths)))
    wide = np.asarray(
        msv_cuda.msv_packed_reference(*_operands([p], tokens, lengths, q=16))
    )
    np.testing.assert_array_equal(narrow, wide)


@pytest.mark.parametrize(
    "impl,platform,want",
    [("auto", "gpu", "cuda"), ("auto", "cpu", "xla"), ("xla", "gpu", "xla"),
     ("xla", "cpu", "xla"), ("cuda", "gpu", "cuda")],
)
def test_resolve_msv_impl(impl, platform, want):
    assert resolve_msv_impl(impl, platform) == want


@pytest.mark.parametrize("impl", ["cuda", "bogus"])
def test_resolve_msv_impl_refuses(impl):
    """The kernel off a GPU is an error, not a quiet switch to XLA."""
    with pytest.raises(ValueError):
        resolve_msv_impl(impl, "cpu")


def test_scanner_refuses_cuda_off_gpu():
    with pytest.raises(ValueError, match="GPU"):
        MSVScanner(msv_impl="cuda")


def test_wide_profile_runs_on_xla(profile_dir):
    """A profile past the compiled widths takes the XLA path by a fixed
    rule of shape, on the CUDA scanner too."""
    sc = MSVScanner(msv_impl="xla")
    sc.msv_impl = "cuda"
    wide = MSVProfile(**{**_load(profile_dir, "100").__dict__, "model_length": 2600})
    assert msv_cuda.states_per_lane(wide.num_states) > msv_cuda.Q_MAX
    assert sc._impl_for(wide) == "xla"
    assert sc._impl_for(_load(profile_dir, "2405")) == "cuda"


# -- on the card -------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("stem", ["100", "1001", "2405"])
def test_kernel_matches_reference(gpu, profile_dir, stem):
    """The compiled kernel against its plain reference, bit for bit, on
    a ragged batch whose size is no multiple of a block's warps."""
    p = _load(profile_dir, stem)
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 300, size=37).astype(np.int32)
    tokens = rng.integers(0, 20, size=(37, 300)).astype(np.int32)
    ops = _operands([p], tokens, lengths)
    got = np.asarray(msv_cuda.msv_packed(*ops))
    want = np.asarray(msv_cuda.msv_packed_reference(*ops))
    np.testing.assert_array_equal(got, want)
