"""Shared MSV recurrence building blocks (JAX).

The per-residue step (reference recurrence MSV_HMM.cpp:100-111, annotated
in ops.reference.msv_oracle) factored out so that the single-device scan
(ops.xla_scan), the CUDA kernel's plain reference (ops.msv_cuda), and the
multi-device sequence-block pipeline (parallel.seqblocks) all share one definition.

Carries and parameters are plain pytrees; every function is traceable and
shape-polymorphic over the leading batch dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = float(-np.inf)


class MSVParams(NamedTuple):
    """Profile constants + per-sequence transition vectors.

    ``scores_real`` is [20, Mr] float32 (finite); ``tr_loop``/``tr_move``
    are [B] float32; ``lengths`` is [B] int32; the three ``tr_*`` profile
    constants are f32 scalars.
    """

    scores_real: jax.Array
    tr_B_Mk: jax.Array
    tr_E_C: jax.Array
    tr_E_J: jax.Array
    lengths: jax.Array
    tr_loop: jax.Array
    tr_move: jax.Array


class MSVCarry(NamedTuple):
    """DP state between residues: M row + special states (all [B, ...])."""

    m: jax.Array  # [B, Mr]
    j: jax.Array  # [B]
    c: jax.Array  # [B]
    n: jax.Array  # [B]
    b: jax.Array  # [B]


def init_carry(params: MSVParams, batch: int, num_states: int) -> MSVCarry:
    """Row-0 initialization (MSV_HMM.cpp:96-97): N=0, B=tr_move, rest -inf."""
    neg_inf = jnp.float32(NEG_INF)
    return MSVCarry(
        m=jnp.full((batch, num_states), neg_inf, dtype=jnp.float32),
        j=jnp.full((batch,), neg_inf, dtype=jnp.float32),
        c=jnp.full((batch,), neg_inf, dtype=jnp.float32),
        n=jnp.zeros((batch,), dtype=jnp.float32),
        b=params.tr_move.astype(jnp.float32),
    )


def msv_step(params: MSVParams, carry: MSVCarry, tok: jax.Array, i: jax.Array) -> MSVCarry:
    """One residue update; ``tok`` is [B] int, ``i`` the global 0-based
    residue index (steps with ``i >= lengths`` are no-ops on the carry)."""
    batch = carry.m.shape[0]
    neg_inf = jnp.float32(NEG_INF)
    emit = params.scores_real[tok]  # exact gather -> [B, Mr]
    shifted = jnp.concatenate(
        [jnp.full((batch, 1), neg_inf, dtype=jnp.float32), carry.m[:, :-1]], axis=1
    )
    new_m = emit + jnp.maximum(shifted, (carry.b + params.tr_B_Mk)[:, None])
    e_st = jnp.max(new_m, axis=1)
    new_j = jnp.maximum(carry.j + params.tr_loop, e_st + params.tr_E_J)
    new_c = jnp.maximum(carry.c + params.tr_loop, e_st + params.tr_E_C)
    new_n = carry.n + params.tr_loop
    new_b = jnp.maximum(new_n + params.tr_move, new_j + params.tr_move)

    valid = i < params.lengths
    return MSVCarry(
        m=jnp.where(valid[:, None], new_m, carry.m),
        j=jnp.where(valid, new_j, carry.j),
        c=jnp.where(valid, new_c, carry.c),
        n=jnp.where(valid, new_n, carry.n),
        b=jnp.where(valid, new_b, carry.b),
    )


def block_scan(
    params: MSVParams,
    carry: MSVCarry,
    tokens: jax.Array,  # [B, Lblk]
    start_index: jax.Array | int = 0,
    unroll: int = 4,
) -> MSVCarry:
    """Scan a contiguous residue block, threading the carry.

    ``start_index`` is the global index of the block's first residue —
    the key to sequence-block sharding (SURVEY.md §7 step 7): a block on
    device p starts at p * Lblk and masks against the true length.
    """
    seq_len = tokens.shape[1]
    xs = (tokens.T, jnp.arange(seq_len, dtype=jnp.int32) + jnp.int32(start_index))

    def step(c, x):
        tok, i = x
        return msv_step(params, c, tok, i), None

    carry, _ = jax.lax.scan(step, carry, xs, unroll=unroll)
    return carry


def final_score(params: MSVParams, carry: MSVCarry) -> jax.Array:
    """Log-odds score: C_final + tr_move (MSV_HMM.cpp:112)."""
    return carry.c + params.tr_move
