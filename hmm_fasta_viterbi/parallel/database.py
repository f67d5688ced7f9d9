"""Database-sharded scans: the data-parallel axis across devices.

Sequences are independent, so the scan is pure data parallelism: shard
the token batch over the ``db`` mesh axis with ``NamedSharding`` and let
XLA run the identical scan program per shard; scores come back sharded
and are gathered (or top-k-reduced) at the end. This is capability the
reference lacks entirely — it scans one sequence at a time on one device
(benchmark_helper.hpp:19-39; SURVEY.md §5 "distributed communication").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..models.msv import MSVProfile, length_transitions
from ..ops.xla_scan import msv_scan
from .mesh import DB_AXIS


@functools.partial(jax.jit, static_argnames=("unroll",))
def _scan_jit(scores_real, tr_B_Mk, tr_E_C, tr_E_J, tokens, lengths, tr_loop, tr_move, unroll=4):
    return msv_scan(scores_real, tr_B_Mk, tr_E_C, tr_E_J, tokens, lengths, tr_loop, tr_move, unroll)


def pad_batch_to_mesh(tokens: np.ndarray, lengths: np.ndarray, num_shards: int):
    """Pad the batch so it divides the db axis; pad rows have length 0
    (scored -inf, dropped by the caller via the returned true size)."""
    b = tokens.shape[0]
    padded = -(-b // num_shards) * num_shards
    if padded != b:
        tokens = np.concatenate(
            [tokens, np.zeros((padded - b, tokens.shape[1]), dtype=tokens.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(padded - b, dtype=lengths.dtype)])
    return tokens, lengths, b


def msv_scan_sharded(
    profile: MSVProfile,
    tokens: np.ndarray,
    lengths: np.ndarray,
    mesh: Mesh,
    unroll: int = 4,
) -> np.ndarray:
    """Scan a database sharded over the mesh's ``db`` axis.

    Returns float32 [B] scores (gathered to host, padding rows removed).
    """
    num_db = mesh.shape[DB_AXIS]
    tokens, lengths, true_b = pad_batch_to_mesh(
        np.asarray(tokens, dtype=np.int32), np.asarray(lengths, dtype=np.int32), num_db
    )
    tr_loop, tr_move = length_transitions(lengths)

    row_sharding = NamedSharding(mesh, PartitionSpec(DB_AXIS, None))
    vec_sharding = NamedSharding(mesh, PartitionSpec(DB_AXIS))
    rep = NamedSharding(mesh, PartitionSpec())

    args = (
        jax.device_put(jnp.asarray(profile.scores_real), rep),
        jax.device_put(jnp.float32(profile.tr_B_Mk), rep),
        jax.device_put(jnp.float32(profile.tr_E_C), rep),
        jax.device_put(jnp.float32(profile.tr_E_J), rep),
        jax.device_put(jnp.asarray(tokens), row_sharding),
        jax.device_put(jnp.asarray(lengths), vec_sharding),
        jax.device_put(jnp.asarray(tr_loop), vec_sharding),
        jax.device_put(jnp.asarray(tr_move), vec_sharding),
    )
    scores = _scan_jit(*args, unroll=unroll)
    return np.asarray(scores)[:true_b]


@functools.lru_cache(maxsize=32)
def make_db_scanner(mesh: Mesh, impl: str = "xla"):
    """MSV database scan sharded over ``db`` via shard_map: each device
    runs the chosen single-device implementation (``cuda``: the kernel
    of ops.msv_cuda; ``xla``: its plain reference) on its local batch
    shard. Inputs use the staged layout of pipeline.MSVScanner.

    Returns a jitted fn(table [P, 20, 32q], tokens_i8 [B_pad, L_pad],
    lengths [B_pad], tr_rows [2, B_pad], consts [P, 3]) -> [P, B_pad].
    """
    from ..ops import msv_cuda

    local = msv_cuda.msv_packed if impl == "cuda" else msv_cuda.msv_packed_reference
    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            PartitionSpec(), PartitionSpec(DB_AXIS, None),
            PartitionSpec(DB_AXIS), PartitionSpec(None, DB_AXIS),
            PartitionSpec(),
        ),
        out_specs=PartitionSpec(None, DB_AXIS),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=32)
def make_db_p7_scanner(mesh: Mesh, stage: str = "viterbi"):
    """db-sharded Viterbi / Forward stage scan (the cascade analogue of
    :func:`make_db_scanner`): each device runs ops.p7_scan on its local
    batch shard.

    Returns a jitted fn(msc, isc, trans, tr_B_Mk, tr_E_C, tr_E_J,
    tokens [B_pad, L_pad], lengths, tr_loop, tr_move) -> scores [B_pad].
    """
    from ..ops import p7_scan

    assert stage in ("viterbi", "forward")
    sr = p7_scan.VITERBI if stage == "viterbi" else p7_scan.FORWARD
    rep = PartitionSpec()
    row = PartitionSpec(DB_AXIS)
    mapped = jax.shard_map(
        functools.partial(p7_scan.p7_scan, sr),
        mesh=mesh,
        in_specs=(rep,) * 6 + (PartitionSpec(DB_AXIS, None), row, row, row),
        out_specs=row,
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.partial(jax.jit, static_argnames=("k",))
def top_k_hits(scores: jax.Array, k: int):
    """Distributed top-k over (possibly sharded) scores.

    Returns (values, indices); under jit with sharded input, XLA inserts
    the cross-device reduction (per-shard top-k + all-gather + final
    top-k) automatically.
    """
    return jax.lax.top_k(scores, k)
