"""Long-sequence block sharding: a wavefront pipeline over the ``sp`` axis.

The MSV recurrence is strictly sequential along residues, but its
cross-block state is tiny — the M row plus the (J, C, N, B) specials at
the block boundary (SURVEY.md §5 "long-context"). So residue blocks of
one sequence are pipelined across chips: device p scans residue block
``[p*Lblk, (p+1)*Lblk)`` of sequence r during wavefront round ``t = p + r``
and hands the boundary carry to device p+1 via ``ppermute``.

With R sequences (rows) per shard-group and S sequence-shards, the
pipeline takes S + R - 1 rounds of one block-scan each — efficiency
R/(S+R-1), approaching 1 for deep batches, and enabling scans of
sequences far longer than one chip could time-step economically.

Composes with the ``db`` axis: tokens sharded P(db, sp) run an
independent wavefront per database shard.

Everything is SPMD inside one jitted ``shard_map`` — no host round-trips
(contrast: the reference crosses the host<->device boundary ~L*(3+log2 M)
times per sequence, SURVEY.md §3.2).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.msv import MSVProfile, length_transitions
from ..ops.recurrence import MSVCarry, MSVParams, block_scan, init_carry
from .mesh import DB_AXIS, SP_AXIS

NEG_INF = float(-np.inf)


def _wavefront(
    scores_real, tr_B_Mk, tr_E_C, tr_E_J, tokens, lengths, tr_loop, tr_move,
    unroll, group,
):
    """Per-device body under shard_map.

    ``tokens`` is the local block [R, Lblk] (rows = local database shard,
    columns = this device's residue block); lengths/tr_* are the local
    [R] rows; scores are replicated. Rows advance through the pipeline
    ``group`` at a time (the in-flight microbatch), so each round scans a
    [group, Lblk] block — wider groups amortize per-round overhead and
    widen the per-round scan; rounds = S + R/group - 1.
    """
    sp_size = jax.lax.axis_size(SP_AXIS)
    p = jax.lax.axis_index(SP_AXIS)
    rows, block_len = tokens.shape
    num_states = scores_real.shape[1]
    num_groups = rows // group
    start_index = p * block_len  # global index of this block's first residue

    def group_params(g0):
        return MSVParams(
            scores_real=scores_real,
            tr_B_Mk=tr_B_Mk,
            tr_E_C=tr_E_C,
            tr_E_J=tr_E_J,
            lengths=jax.lax.dynamic_slice(lengths, (g0,), (group,)),
            tr_loop=jax.lax.dynamic_slice(tr_loop, (g0,), (group,)),
            tr_move=jax.lax.dynamic_slice(tr_move, (g0,), (group,)),
        )

    def round_body(t, state):
        carry_in, out = state
        g = t - p  # wavefront: device p scans row-group g at round p + g
        valid = (g >= 0) & (g < num_groups)
        g0 = jnp.clip(g, 0, num_groups - 1) * group
        params = group_params(g0)

        # device 0 starts fresh sequences each round; downstream devices
        # resume from the boundary carry received from device p-1
        fresh = init_carry(params, group, num_states)
        carry = jax.tree.map(
            lambda f, c: jnp.where(p == 0, f, c), fresh, carry_in
        )

        toks = jax.lax.dynamic_slice(tokens, (g0, 0), (group, block_len))
        new_carry = block_scan(params, carry, toks, start_index=start_index, unroll=unroll)
        # masked rounds must not corrupt the in-flight carry
        new_carry = jax.tree.map(
            lambda n, o: jnp.where(valid, n, o), new_carry, carry_in
        )

        # last pipeline stage emits the final scores for this group
        score = new_carry.c + params.tr_move
        emit = (p == sp_size - 1) & valid
        cur = jax.lax.dynamic_slice(out, (g0,), (group,))
        out = jax.lax.dynamic_update_slice(
            out, jnp.where(emit, score, cur), (g0,)
        )

        # boundary-carry exchange p -> p+1
        carry_out = jax.tree.map(
            lambda x: jax.lax.ppermute(
                x, SP_AXIS, [(i, (i + 1) % sp_size) for i in range(sp_size)]
            ),
            new_carry,
        )
        return carry_out, out

    carry0 = MSVCarry(
        m=jnp.zeros((group, num_states), dtype=jnp.float32),
        j=jnp.zeros((group,), dtype=jnp.float32),
        c=jnp.zeros((group,), dtype=jnp.float32),
        n=jnp.zeros((group,), dtype=jnp.float32),
        b=jnp.zeros((group,), dtype=jnp.float32),
    )
    out0 = jnp.zeros((rows,), dtype=jnp.float32)
    num_rounds = sp_size + num_groups - 1
    _, out = jax.lax.fori_loop(0, num_rounds, round_body, (carry0, out0))
    # only the last stage wrote scores; replicate over sp
    return jax.lax.psum(out, SP_AXIS)


@functools.lru_cache(maxsize=32)
def make_seqblock_scanner(mesh: Mesh, unroll: int = 4, group: int = 8):
    """Build the jitted sharded scan fn for a (db, sp) mesh (cached)."""
    fn = functools.partial(_wavefront, unroll=unroll, group=group)
    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(
            P(),  # scores_real (replicated)
            P(), P(), P(),  # tr_B_Mk, tr_E_C, tr_E_J
            P(DB_AXIS, SP_AXIS),  # tokens: rows over db, residue blocks over sp
            P(DB_AXIS), P(DB_AXIS), P(DB_AXIS),  # lengths, tr_loop, tr_move
        ),
        out_specs=P(DB_AXIS),
        check_vma=False,
    )
    return jax.jit(mapped)


def msv_scan_seqblocks(
    profile: MSVProfile,
    tokens: np.ndarray,
    lengths: np.ndarray,
    mesh: Mesh,
    unroll: int = 4,
    group: int = 8,
) -> np.ndarray:
    """Scan with residue blocks sharded over ``sp`` (and rows over ``db``).

    Tokens are padded so rows divide db * group and columns divide the
    sp axis; pad steps/rows are masked by the true lengths.
    """
    num_db = mesh.shape[DB_AXIS]
    num_sp = mesh.shape[SP_AXIS]
    tokens = np.asarray(tokens, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    b, seq_len = tokens.shape

    group = min(group, max(1, -(-b // num_db)))
    pad_b = -(-b // (num_db * group)) * num_db * group
    pad_l = -(-seq_len // num_sp) * num_sp
    padded = np.zeros((pad_b, pad_l), dtype=np.int32)
    padded[:b, :seq_len] = tokens
    lengths_p = np.zeros(pad_b, dtype=np.int32)
    lengths_p[:b] = lengths
    tr_loop, tr_move = length_transitions(lengths_p)

    scanner = make_seqblock_scanner(mesh, unroll=unroll, group=group)
    out = scanner(
        jnp.asarray(profile.scores_real),
        jnp.float32(profile.tr_B_Mk),
        jnp.float32(profile.tr_E_C),
        jnp.float32(profile.tr_E_J),
        jnp.asarray(padded),
        jnp.asarray(lengths_p),
        jnp.asarray(tr_loop),
        jnp.asarray(tr_move),
    )
    return np.asarray(out)[:b]


@dataclasses.dataclass
class _HostStaged:
    """Host-side stand-in for StagedDatabase: the wavefront pads and
    shards per call, so 'staging' just pins the encoded arrays."""

    tokens: np.ndarray
    lengths: np.ndarray
    num_sequences: int


class SeqblockScanner:
    """MSVScanner-compatible adapter that routes the MSV stage through
    the sp-axis wavefront (``--mesh db=N,sp=M`` with sp > 1): residue
    blocks of each sequence pipeline across the sp axis with ppermute
    boundary-carry hops. The Viterbi and Forward stages have no
    wavefront, so :meth:`scan_p7` refuses."""

    mesh = None  # no db-mesh scanner branches; sharding lives in sp_mesh

    def __init__(self, sp_mesh: Mesh):
        self.sp_mesh = sp_mesh

    def stage(self, tokens: np.ndarray, lengths: np.ndarray) -> _HostStaged:
        tokens = np.asarray(tokens)
        return _HostStaged(
            tokens, np.asarray(lengths, np.int32), tokens.shape[0]
        )

    def stage_fasta(self, db) -> _HostStaged:
        return self.stage(*db.encode())

    def scan(self, profile: MSVProfile, staged: _HostStaged):
        return msv_scan_seqblocks(
            profile, staged.tokens, staged.lengths, self.sp_mesh
        )

    def scan_filter(self, profile: MSVProfile, staged: _HostStaged):
        return self.scan(profile, staged)

    def scan_p7(self, p7, staged: _HostStaged, stage: str = "viterbi"):
        raise ValueError(
            f"the {stage} stage has no sequence-parallel wavefront; "
            "run it without sp > 1 in --mesh"
        )

    scan_p7_filter = scan_p7

    def scan_many(self, profiles, staged: _HostStaged, mode: str = "exact"):
        return {
            p.name: np.asarray(self.scan(p, staged)) for p in profiles
        }
