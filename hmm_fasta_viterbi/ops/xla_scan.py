"""XLA-compiled MSV scan: the whole residue recurrence inside ONE program.

This is the plain answer to the reference's launch-bound OpenCL host
loop (algorithms/MSV_HMM.cpp:269-430 enqueues ~L*(3+log2 M) kernels per
sequence — SURVEY.md §3.2): here the full scan is a single
``jax.lax.scan`` under ``jit``, batched over sequences, with the E-state
reduction fused into each step. Emission selection uses an exact gather
(``scores_real[tok]``), so scores match the float32 oracle bit-for-bit up
to libm ulp differences — well inside the reference's 1e-4 tolerance
(algorithms/test_MSV.cpp:10-12).

The per-step recurrence lives in ops.recurrence (shared with the CUDA
kernel's plain reference, ops.msv_cuda, and the multi-device
sequence-block pipeline).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.msv import MSVProfile, length_transitions
from .recurrence import MSVParams, block_scan, final_score, init_carry


def msv_scan(
    scores_real: jax.Array,  # [20, Mr] f32, finite
    tr_B_Mk: jax.Array,  # f32 scalar
    tr_E_C: jax.Array,  # f32 scalar
    tr_E_J: jax.Array,  # f32 scalar
    tokens: jax.Array,  # [B, L] int32 (0..19; padded steps masked)
    lengths: jax.Array,  # [B] int32
    tr_loop: jax.Array,  # [B] f32 (precomputed log(L/(L+3)))
    tr_move: jax.Array,  # [B] f32 (precomputed log(3/(L+3)))
    unroll: int = 4,
) -> jax.Array:
    """Score a padded batch of sequences; returns f32 [B] log-odds.

    Pure function — safe to ``jit``/``pjit``/``shard_map`` directly.
    """
    batch = tokens.shape[0]
    num_states = scores_real.shape[1]
    params = MSVParams(scores_real, tr_B_Mk, tr_E_C, tr_E_J, lengths, tr_loop, tr_move)
    carry = init_carry(params, batch, num_states)
    carry = block_scan(params, carry, tokens, start_index=0, unroll=unroll)
    return final_score(params, carry)


msv_scan_batch = jax.jit(msv_scan, static_argnames=("unroll",))


def msv_xla(
    profile: MSVProfile,
    tokens: np.ndarray | jax.Array,
    lengths: np.ndarray | jax.Array,
    unroll: int = 4,
) -> jax.Array:
    """Convenience wrapper: prepares f32 constants on host and scans."""
    tr_loop, tr_move = length_transitions(np.asarray(lengths))
    return msv_scan_batch(
        jnp.asarray(profile.scores_real),
        jnp.float32(profile.tr_B_Mk),
        jnp.float32(profile.tr_E_C),
        jnp.float32(profile.tr_E_J),
        jnp.asarray(tokens, dtype=jnp.int32),
        jnp.asarray(lengths, dtype=jnp.int32),
        jnp.asarray(tr_loop, dtype=jnp.float32),
        jnp.asarray(tr_move, dtype=jnp.float32),
        unroll=unroll,
    )
