"""Viterbi and Forward scans for the full profile HMM (JAX, single
program), batched over sequences like the MSV path.

Both stages share one implementation parameterized by a (max,+) /
(logsumexp,+) semiring. The profile-HMM-specific hard part is the same-row
delete chain

    D_j(i) = combine(M_{j-1}(i) + tmd[j-1],  D_{j-1}(i) + tdd[j-1])

which is sequential along the state axis in scalar form; here it runs as
an ASSOCIATIVE affine scan: elements (a_j, c_j) with
    (a1, c1) (+) (a2, c2) = (combine(a2, a1 + c2), c1 + c2)
computed by ``jax.lax.associative_scan`` in O(log M) vector passes, in
place of HMMER's striped lazy-F fixup loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..models.msv import length_transitions
from ..models.p7 import P7Profile

NEG_INF = float(-np.inf)


@dataclasses.dataclass(frozen=True)
class Semiring:
    combine: Callable  # binary: max or logaddexp
    reduce: Callable  # (x, axis) -> reduced


VITERBI = Semiring(combine=jnp.maximum, reduce=jnp.max)
FORWARD = Semiring(
    combine=jnp.logaddexp,
    reduce=lambda x, axis: jax.scipy.special.logsumexp(x, axis=axis),
)


def _shift_state(x: jax.Array) -> jax.Array:
    """j-1 shift along the last (state) axis, -inf fill at j=0."""
    pad = jnp.full(x.shape[:-1] + (1,), NEG_INF, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-1]], axis=-1)


def _delete_chain(sr: Semiring, a: jax.Array, c: jax.Array) -> jax.Array:
    """Affine scan along states: D_j = combine(a_j, D_{j-1} + c_j)."""

    def op(left, right):
        a1, c1 = left
        a2, c2 = right
        return sr.combine(a2, a1 + c2), c1 + c2

    d, _ = jax.lax.associative_scan(op, (a, jnp.broadcast_to(c, a.shape)), axis=-1)
    return d


def p7_scan(
    sr: Semiring,
    msc: jax.Array,  # [20, Mr]
    isc: jax.Array,  # [20, Mr]
    trans: jax.Array,  # [7, Mr] rows: tmm tmi tmd tim tii tdm tdd
    tr_B_Mk: jax.Array,
    tr_E_C: jax.Array,
    tr_E_J: jax.Array,
    tokens: jax.Array,  # [B, L] int32
    lengths: jax.Array,  # [B] int32
    tr_loop: jax.Array,  # [B] f32
    tr_move: jax.Array,  # [B] f32
    unroll: int = 1,
) -> jax.Array:
    """Score a padded batch; returns f32 [B] (C_final + tr_move)."""
    batch, seq_len = tokens.shape
    neg_inf = jnp.float32(NEG_INF)
    tmm, tmi, tmd, tim, tii, tdm, tdd = (trans[k] for k in range(7))
    # the delete-chain multiplier indexes j-1: c_j = tdd[j-1]
    tdd_s = _shift_state(tdd)

    num_states = msc.shape[1]
    init = (
        jnp.full((batch, num_states), neg_inf, dtype=jnp.float32),  # M
        jnp.full((batch, num_states), neg_inf, dtype=jnp.float32),  # I
        jnp.full((batch, num_states), neg_inf, dtype=jnp.float32),  # D
        jnp.full((batch,), neg_inf, dtype=jnp.float32),  # J
        jnp.full((batch,), neg_inf, dtype=jnp.float32),  # C
        jnp.zeros((batch,), dtype=jnp.float32),  # N
        tr_move.astype(jnp.float32),  # B
    )

    def step(carry, x):
        m, i_st, d, j_st, c_st, n_st, b_st = carry
        tok, i = x
        ms = msc[tok]  # [B, Mr]
        is_ = isc[tok]

        # M: best of {B entry, M/I/D diagonal} (combine-reduced)
        diag = sr.combine(
            sr.combine(_shift_state(m + tmm), _shift_state(i_st + tim)),
            _shift_state(d + tdm),
        )
        new_m = ms + sr.combine(diag, (b_st + tr_B_Mk)[:, None])
        # I: vertical within node
        new_i = is_ + sr.combine(m + tmi, i_st + tii)
        # D: same-row affine chain along states
        new_d = _delete_chain(sr, _shift_state(new_m + tmd), tdd_s)
        # E: local exit from every M and D (score 0)
        e_st = sr.combine(sr.reduce(new_m, axis=1), sr.reduce(new_d, axis=1))
        new_j = sr.combine(j_st + tr_loop, e_st + tr_E_J)
        new_c = sr.combine(c_st + tr_loop, e_st + tr_E_C)
        new_n = n_st + tr_loop
        new_b = sr.combine(new_n + tr_move, new_j + tr_move)

        valid = i < lengths
        vc = valid[:, None]
        carry = (
            jnp.where(vc, new_m, m),
            jnp.where(vc, new_i, i_st),
            jnp.where(vc, new_d, d),
            jnp.where(valid, new_j, j_st),
            jnp.where(valid, new_c, c_st),
            jnp.where(valid, new_n, n_st),
            jnp.where(valid, new_b, b_st),
        )
        return carry, None

    xs = (tokens.T, jnp.arange(seq_len, dtype=jnp.int32))
    carry, _ = jax.lax.scan(step, init, xs, unroll=unroll)
    return carry[4] + tr_move  # C + final move


viterbi_jit = jax.jit(functools.partial(p7_scan, VITERBI), static_argnames=("unroll",))
forward_jit = jax.jit(functools.partial(p7_scan, FORWARD), static_argnames=("unroll",))


def pack_profile(profile: P7Profile):
    trans = np.stack(
        [profile.tmm, profile.tmi, profile.tmd, profile.tim, profile.tii,
         profile.tdm, profile.tdd]
    ).astype(np.float32)
    return (
        jnp.asarray(profile.msc),
        jnp.asarray(profile.isc),
        jnp.asarray(trans),
        jnp.float32(profile.tr_B_Mk),
        jnp.float32(profile.tr_E_C),
        jnp.float32(profile.tr_E_J),
    )


def _run(jitted, profile, tokens, lengths, unroll=1):
    tr_loop, tr_move = length_transitions(np.asarray(lengths))
    return jitted(
        *pack_profile(profile),
        jnp.asarray(tokens, dtype=jnp.int32),
        jnp.asarray(lengths, dtype=jnp.int32),
        jnp.asarray(tr_loop, dtype=jnp.float32),
        jnp.asarray(tr_move, dtype=jnp.float32),
        unroll=unroll,
    )


def _suffix_delete_chain(a: jax.Array, c: jax.Array) -> jax.Array:
    """Right-to-left affine scan: D_j = LSE(a_j, D_{j+1} + c_j) — the
    suffix mirror of :func:`_delete_chain`."""

    def op(left, right):
        a1, c1 = left
        a2, c2 = right
        return jnp.logaddexp(a2, a1 + c2), c1 + c2

    # (positive axis: reverse=True rejects negative axes)
    d, _ = jax.lax.associative_scan(
        op, (a, jnp.broadcast_to(c, a.shape)), axis=a.ndim - 1, reverse=True
    )
    return d


def backward_scan(
    msc: jax.Array,  # [20, Mr]
    isc: jax.Array,  # [20, Mr]
    trans: jax.Array,  # [7, Mr]
    tr_B_Mk: jax.Array,
    tr_E_C: jax.Array,
    tr_E_J: jax.Array,
    tokens: jax.Array,  # [B, L] int32
    lengths: jax.Array,  # [B] int32
    tr_loop: jax.Array,  # [B] f32
    tr_move: jax.Array,  # [B] f32
) -> jax.Array:
    """Batched Backward totals beta_0(N), f32 [B].

    The suffix recurrence of ops.reference.backward_oracle: steps run
    right-to-left over the PADDED width; steps at positions >= length
    are identity (the t = L boundary state is injected exactly when the
    reversed step index first enters the valid range), so one jitted
    program serves ragged batches.
    """
    batch, seq_len = tokens.shape
    neg_inf = jnp.float32(NEG_INF)
    tmm, tmi, tmd, tim, tii, tdm, tdd = (trans[k] for k in range(7))
    num_states = msc.shape[1]
    lse = jnp.logaddexp

    def shift_left(x):  # j+1 -> j, -inf fill at j = Mr-1
        pad = jnp.full(x.shape[:-1] + (1,), NEG_INF, dtype=x.dtype)
        return jnp.concatenate([x[..., 1:], pad], axis=-1)

    # t = L boundary (per-lane; injected when a lane becomes active)
    bc_L = tr_move  # [B]
    be_L = tr_E_C + bc_L
    # boundary D: suffix chain with a_j = be_L, c_j = tdd[j]
    bd_L = _suffix_delete_chain(
        jnp.broadcast_to(be_L[:, None], (batch, num_states)),
        tdd[None, :],
    )
    bm_L = lse(tmd[None, :] + shift_left(bd_L), be_L[:, None])

    init = (
        jnp.full((batch, num_states), neg_inf, dtype=jnp.float32),  # M
        jnp.full((batch, num_states), neg_inf, dtype=jnp.float32),  # I
        jnp.full((batch,), neg_inf, dtype=jnp.float32),  # J
        jnp.full((batch,), neg_inf, dtype=jnp.float32),  # C
        jnp.full((batch,), neg_inf, dtype=jnp.float32),  # N
    )

    def step(carry, x):
        b_m, b_i, b_j, b_c, b_n = carry
        tok, t = x  # t = original position index, scanned L-1 .. 0
        # lanes whose length ends exactly after this token load the
        # boundary state; shorter lanes stay inert until their turn
        at_end = (t == lengths - 1)[:, None]
        b_m = jnp.where(at_end, bm_L, b_m)
        b_i = jnp.where(at_end, neg_inf, b_i)
        b_j = jnp.where(at_end[:, 0], neg_inf, b_j)
        b_c = jnp.where(at_end[:, 0], bc_L, b_c)
        b_n = jnp.where(at_end[:, 0], neg_inf, b_n)

        ms_n = msc[tok]  # [B, Mr]
        is_n = isc[tok]
        memit = ms_n + b_m
        iemit = is_n + b_i
        m_next = shift_left(memit)

        new_b = jax.scipy.special.logsumexp(tr_B_Mk + memit, axis=1)
        new_j = lse(tr_loop + b_j, tr_move + new_b)
        new_n = lse(tr_loop + b_n, tr_move + new_b)
        new_c = tr_loop + b_c
        new_e = lse(tr_E_C + new_c, tr_E_J + new_j)

        new_i = lse(tim[None, :] + m_next, tii[None, :] + iemit)
        a0 = lse(tdm[None, :] + m_next, new_e[:, None])
        new_d = _suffix_delete_chain(a0, tdd[None, :])
        new_m = lse(
            lse(tmm[None, :] + m_next, tmi[None, :] + iemit),
            lse(tmd[None, :] + shift_left(new_d), new_e[:, None]),
        )

        valid = (t < lengths)[:, None]
        carry = (
            jnp.where(valid, new_m, b_m),
            jnp.where(valid, new_i, b_i),
            jnp.where(valid[:, 0], new_j, b_j),
            jnp.where(valid[:, 0], new_c, b_c),
            jnp.where(valid[:, 0], new_n, b_n),
        )
        return carry, None

    xs = (
        tokens.T[::-1],
        jnp.arange(seq_len - 1, -1, -1, dtype=jnp.int32),
    )
    carry, _ = jax.lax.scan(step, init, xs)
    total = carry[4]
    return jnp.where(lengths > 0, total, neg_inf)


_backward_jit = jax.jit(backward_scan)


def backward_xla(profile: P7Profile, tokens, lengths) -> jax.Array:
    """Batched Backward scores (must equal forward_xla), f32 [B]."""
    tr_loop, tr_move = length_transitions(np.asarray(lengths))
    return _backward_jit(
        *pack_profile(profile),
        jnp.asarray(tokens, dtype=jnp.int32),
        jnp.asarray(lengths, dtype=jnp.int32),
        jnp.asarray(tr_loop, dtype=jnp.float32),
        jnp.asarray(tr_move, dtype=jnp.float32),
    )


def _posterior_scan(
    msc, isc, trans, tr_B_Mk, tr_E_C, tr_E_J, tokens, length, tr_loop, tr_move
):
    """Single-sequence forward-backward match posteriors, jitted.

    tokens [L_pad] int32, ``length`` the true length (padding masked in
    both passes so compiles are shared per L bucket). Returns
    (post [L_pad, Mr] f32 — rows >= length are zero, total f32).
    O(L_pad*Mr) device memory for the saved forward rows — used for hit
    postprocessing, not database scans.
    """
    seq_len = tokens.shape[0]
    num_states = msc.shape[1]
    neg_inf = jnp.float32(NEG_INF)
    tmm, tmi, tmd, tim, tii, tdm, tdd = (trans[k] for k in range(7))
    tdd_s = _shift_state(tdd)
    lse = jnp.logaddexp
    sr = FORWARD

    def shift_left(x):
        pad = jnp.full(x.shape[:-1] + (1,), NEG_INF, dtype=x.dtype)
        return jnp.concatenate([x[..., 1:], pad], axis=-1)

    # ---- forward, saving M rows --------------------------------------
    def fstep(carry, tok):
        m, i_st, d, j_st, c_st, n_st, b_st = carry
        ms = msc[tok]
        is_ = isc[tok]
        diag = lse(lse(_shift_state(m + tmm), _shift_state(i_st + tim)),
                   _shift_state(d + tdm))
        new_m = ms + lse(diag, b_st + tr_B_Mk)
        new_i = is_ + lse(m + tmi, i_st + tii)
        new_d = _delete_chain(sr, _shift_state(new_m + tmd), tdd_s)
        e_st = lse(
            jax.scipy.special.logsumexp(new_m),
            jax.scipy.special.logsumexp(new_d),
        )
        j_st = lse(j_st + tr_loop, e_st + tr_E_J)
        c_st = lse(c_st + tr_loop, e_st + tr_E_C)
        n_st = n_st + tr_loop
        b_st = lse(n_st + tr_move, j_st + tr_move)
        return (new_m, new_i, new_d, j_st, c_st, n_st, b_st), new_m

    def fstep_masked(carry, x):
        tok, t = x
        new_carry, row = fstep(carry, tok)
        valid = t < length
        keep = jax.tree.map(
            lambda n, o: jnp.where(valid, n, o), new_carry, carry
        )
        return keep, jnp.where(valid, row, neg_inf)

    finit = (
        jnp.full(num_states, neg_inf), jnp.full(num_states, neg_inf),
        jnp.full(num_states, neg_inf),
        neg_inf, neg_inf, jnp.float32(0.0), tr_move,
    )
    fcarry, fwd_m = jax.lax.scan(
        fstep_masked, finit, (tokens, jnp.arange(seq_len, dtype=jnp.int32))
    )
    total = fcarry[4] + tr_move

    # ---- backward, saving M rows (suffix recurrence) -----------------
    bc_L = tr_move
    be_L = tr_E_C + bc_L
    bd_L = _suffix_delete_chain(jnp.full(num_states, be_L), tdd)
    bm_L = lse(tmd + shift_left(bd_L), be_L)

    def bstep(carry, tok):
        b_m, b_i, b_j, b_c, b_n = carry
        ms_n = msc[tok]
        is_n = isc[tok]
        memit = ms_n + b_m
        iemit = is_n + b_i
        m_next = shift_left(memit)
        new_b = jax.scipy.special.logsumexp(tr_B_Mk + memit)
        new_j = lse(tr_loop + b_j, tr_move + new_b)
        new_n = lse(tr_loop + b_n, tr_move + new_b)
        new_c = tr_loop + b_c
        new_e = lse(tr_E_C + new_c, tr_E_J + new_j)
        new_i = lse(tim + m_next, tii + iemit)
        a0 = lse(tdm + m_next, new_e)
        new_d = _suffix_delete_chain(a0, tdd)
        new_m = lse(lse(tmm + m_next, tmi + iemit),
                    lse(tmd + shift_left(new_d), new_e))
        return (new_m, new_i, new_j, new_c, new_n), b_m

    def bstep_masked(carry, x):
        tok, t = x  # t = original position, scanned L_pad-1 .. 0
        b_m, b_i, b_j, b_c, b_n = carry
        at_end = t == length - 1
        carry = (
            jnp.where(at_end, bm_L, b_m),
            jnp.where(at_end, neg_inf, b_i),
            jnp.where(at_end, neg_inf, b_j),
            jnp.where(at_end, bc_L, b_c),
            jnp.where(at_end, neg_inf, b_n),
        )
        new_carry, row = bstep(carry, tok)
        valid = t < length
        keep = jax.tree.map(
            lambda n, o: jnp.where(valid, n, o), new_carry, carry
        )
        return keep, jnp.where(valid, row, neg_inf)

    binit = (
        jnp.full(num_states, neg_inf), jnp.full(num_states, neg_inf),
        neg_inf, bc_L, neg_inf,
    )
    _, bwd_m_rev = jax.lax.scan(
        bstep_masked,
        binit,
        (tokens[::-1], jnp.arange(seq_len - 1, -1, -1, dtype=jnp.int32)),
    )
    # bwd_m_rev[k] = beta rows BEFORE processing reversed token k, i.e.
    # beta at (original position + 1); forward row t pairs with beta row
    # t (both "after t+1 tokens") -> reverse back
    bwd_m = bwd_m_rev[::-1]

    post = jnp.exp((fwd_m + bwd_m) - total)
    return post.astype(jnp.float32), total


_posterior_jit = jax.jit(_posterior_scan)


def posterior_match_xla(profile: P7Profile, tokens) -> tuple[jax.Array, jax.Array]:
    """Jitted forward-backward match posteriors for ONE sequence.

    Returns (post [L, Mr] f32, total score). Same semantics as
    ops.reference.posterior_match but runs on device (the NumPy oracle's
    per-state Python chain loop is minutes-slow at M ~ 1400). Tokens pad
    to 128-multiples so hits of different lengths share compiles."""
    tokens = np.asarray(tokens, dtype=np.int32)
    length = int(tokens.shape[0])
    l_pad = max(128, -(-length // 128) * 128)
    padded = np.zeros(l_pad, dtype=np.int32)
    padded[:length] = tokens
    post, total = _posterior_jit(
        *pack_profile(profile),
        jnp.asarray(padded),
        jnp.int32(length),
        *(jnp.float32(x) for x in length_transitions(length)),
    )
    return post[:length], total


def _coverage_scan(
    msc, isc, trans, tr_B_Mk, tr_E_C, tr_E_J, tokens, length, tr_loop, tr_move
):
    """Summed match-posterior coverage per position (the quantity the
    domain-envelope report consumes) — reduces on device so the batched
    path never ships the [L, Mr] posterior matrix to host."""
    post, total = _posterior_scan(
        msc, isc, trans, tr_B_Mk, tr_E_C, tr_E_J, tokens, length,
        tr_loop, tr_move,
    )
    return post.sum(axis=1), total


_coverage_batch_jit = jax.jit(
    jax.vmap(_coverage_scan, in_axes=(None,) * 6 + (0, 0, 0, 0))
)


def posterior_coverage_batch_xla(
    profile: P7Profile, tokens, lengths, chunk: int = 32
) -> tuple[np.ndarray, np.ndarray]:
    """Batched forward-backward match coverage for MANY sequences.

    Returns (coverage [B, L_pad] f32 — summed match posterior per
    position, rows >= lengths[b] zero; totals [B] f32). One device call
    per ``chunk`` sequences (vmapped over the single-sequence
    forward-backward) instead of the per-hit loop — wall time sublinear
    in hit count (VERDICT r1 #4). ``chunk`` bounds the transient
    [chunk, L_pad, Mr] saved-rows memory; the last chunk pads by
    repetition so every call shares one compile per L bucket.
    """
    tokens = np.asarray(tokens, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    b, seq_len = tokens.shape
    l_pad = max(128, -(-seq_len // 128) * 128)
    padded = np.zeros((b, l_pad), dtype=np.int32)
    padded[:, :seq_len] = tokens
    # ragged tails beyond each length are masked by the scans themselves
    tr_loop, tr_move = length_transitions(lengths)
    packed = pack_profile(profile)

    cov = np.zeros((b, l_pad), dtype=np.float32)
    totals = np.zeros(b, dtype=np.float32)
    for lo in range(0, b, chunk):
        hi = min(lo + chunk, b)
        sel = np.arange(lo, hi)
        if hi - lo < chunk:  # pad by repetition: one compile per bucket
            sel = np.concatenate(
                [sel, np.full(chunk - (hi - lo), lo, dtype=sel.dtype)]
            )
        c, t = _coverage_batch_jit(
            *packed,
            jnp.asarray(padded[sel]),
            jnp.asarray(lengths[sel]),
            jnp.asarray(tr_loop[sel]),
            jnp.asarray(tr_move[sel]),
        )
        cov[lo:hi] = np.asarray(c)[: hi - lo]
        totals[lo:hi] = np.asarray(t)[: hi - lo]
    return cov, totals


def viterbi_xla(profile: P7Profile, tokens, lengths, unroll: int = 1) -> jax.Array:
    """Full local Viterbi filter scores, f32 [B]."""
    return _run(viterbi_jit, profile, tokens, lengths, unroll)


def forward_xla(profile: P7Profile, tokens, lengths, unroll: int = 1) -> jax.Array:
    """Forward filter scores (log-space), f32 [B]."""
    return _run(forward_jit, profile, tokens, lengths, unroll)
