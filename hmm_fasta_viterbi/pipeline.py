"""End-to-end scan pipeline: the user-facing engine API.

The reference never finished its CLI (main.cpp is a stub — SURVEY.md
component #16); this module is the production entry: stage a sequence
database on device once, then scan any number of profiles against it
(the reference sweep workload, algorithms/benchmark_MSV.cpp, does exactly
this shape of work: one FASTA x 24 profiles).

* tokens ship int8 as [B, L] rows and live on device across profile
  scans; batch and length pad to buckets so ragged batches share
  compiled programs;
* profile tables are small ([20, M] ~ 200 KB) and cached on device keyed
  by profile identity;
* the MSV stage runs the CUDA kernel (ops.msv_cuda) on a GPU and the
  plain XLA scan elsewhere (:func:`resolve_msv_impl`); the Viterbi,
  Forward and posterior stages are XLA on every platform (ops.p7_scan).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

from .io.fastaio import FastaDatabase
from .models.msv import MSVProfile, length_transitions
from .ops import msv_cuda

logger = logging.getLogger(__name__)

MsvImpl = Literal["auto", "cuda", "xla"]
MSV_IMPLS = ("auto", "cuda", "xla")

# batch padding granularity: staged batches of nearby sizes share one
# compiled program
B_BUCKET = 128


def resolve_msv_impl(impl: str, platform: str | None = None) -> str:
    """The MSV implementation for a platform: ``auto`` is the CUDA kernel
    on a GPU and XLA elsewhere. ``cuda`` off a GPU is an error."""
    platform = platform or jax.default_backend()
    if impl not in MSV_IMPLS:
        raise ValueError(f"unknown MSV implementation {impl!r}")
    if impl == "auto":
        return "cuda" if platform == "gpu" else "xla"
    if impl == "cuda" and platform != "gpu":
        raise ValueError(
            f"the CUDA MSV kernel needs a GPU; this platform is {platform!r}"
        )
    return impl


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class StagedDatabase:
    """Device-resident encoded sequence database."""

    tokens_i8: jax.Array  # [B_pad, L_pad] int8 (0 past each length)
    lengths: jax.Array  # [B_pad] int32
    tr_rows: jax.Array  # [2, B_pad] f32 (log-space loop/move)
    num_sequences: int  # true B before padding

    @property
    def total_residues(self) -> int:
        return int(np.asarray(self.lengths).sum())


class MSVScanner:
    """Profile-HMM MSV scan engine.

    >>> scanner = MSVScanner()
    >>> staged = scanner.stage(tokens, lengths)
    >>> scores = scanner.scan(profile, staged)
    """

    @classmethod
    def from_config(cls, config) -> "MSVScanner":
        """Build from a runtime.config.EngineConfig. ``use_mesh`` builds
        a (mesh_db x mesh_sp) device mesh and shards every scan over its
        db axis."""
        mesh = None
        if getattr(config, "use_mesh", False):
            from .parallel.mesh import make_scan_mesh

            mesh = make_scan_mesh(db=config.mesh_db, sp=config.mesh_sp)
        return cls(msv_impl=config.msv_impl, l_chunk=config.l_chunk, mesh=mesh)

    def __init__(
        self,
        msv_impl: MsvImpl = "auto",
        l_chunk: int = 256,
        mesh=None,
    ):
        self.msv_impl = resolve_msv_impl(msv_impl)
        # staged lengths pad to a multiple of l_chunk (one compiled
        # program per length bucket); the CUDA kernel needs 16
        assert l_chunk % msv_cuda.L_MULTIPLE == 0
        self.l_chunk = l_chunk
        # multi-device: a jax.sharding.Mesh with a "db" axis; every scan
        # shards the staged batch across it (parallel.database)
        self.mesh = mesh
        # cache entries are (profile_object, payload): the stored strong
        # reference pins the object so its id() can never be recycled to
        # a different profile (id-keyed caches silently return a STALE
        # entry when a collected profile's address is reused — found as
        # a 1-in-several-runs test flake with 100%-wrong scores).
        # LRU-bounded: a Pfam-scale sweep iterates thousands of profiles
        # once; without eviction every profile's device pack stays pinned
        # in device memory for the process lifetime
        self._profile_cache: collections.OrderedDict = collections.OrderedDict()

    #: max cached entries (a profile contributes a couple of keys —
    #: MSV table, p7 pack); 64 comfortably covers the 24-profile sweep
    #: while bounding Pfam-scale runs
    _CACHE_MAX = 64

    def _cache_get(self, key, obj):
        hit = self._profile_cache.get(key)
        if hit is not None and hit[0] is obj:
            self._profile_cache.move_to_end(key)
            return hit[1]
        return None

    def _cache_put(self, key, obj, payload):
        self._profile_cache[key] = (obj, payload)
        self._profile_cache.move_to_end(key)
        while len(self._profile_cache) > self._CACHE_MAX:
            self._profile_cache.popitem(last=False)  # evict LRU device pack
        return payload

    # -- mesh plumbing ---------------------------------------------------
    def _b_gran(self) -> int:
        """Batch padding granularity: every db shard holds whole buckets."""
        if self.mesh is None:
            return B_BUCKET
        from .parallel.mesh import DB_AXIS

        return B_BUCKET * self.mesh.shape[DB_AXIS]

    def _dev(self, arr, b_axis: int):
        """Upload ``arr`` (B_pad along dim ``b_axis``), sharded over the
        mesh's db axis when a mesh is configured."""
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec

        from .parallel.mesh import DB_AXIS

        spec = [None] * np.ndim(arr)
        spec[b_axis] = DB_AXIS
        return jax.device_put(
            arr, NamedSharding(self.mesh, PartitionSpec(*spec))
        )

    # -- staging ---------------------------------------------------------
    def _staged(self, tokens_dev, lengths_p: np.ndarray, b: int) -> StagedDatabase:
        tr_loop, tr_move = length_transitions(lengths_p)
        return StagedDatabase(
            tokens_i8=tokens_dev,
            lengths=self._dev(lengths_p, 0),
            tr_rows=self._dev(
                np.stack([tr_loop, tr_move]).astype(np.float32), 1
            ),
            num_sequences=b,
        )

    def stage(self, tokens: np.ndarray, lengths: np.ndarray) -> StagedDatabase:
        """Pad + upload a token batch once; reusable across profiles."""
        tokens = np.asarray(tokens)
        lengths = np.asarray(lengths, dtype=np.int32)
        b, seq_len = tokens.shape

        b_pad = _round_up(max(b, 1), self._b_gran())
        # one compile per (L bucket, B bucket) pair; a database is staged
        # once, so l_chunk-granular buckets beat power-of-2 padding waste
        l_pad = _round_up(max(seq_len, 1), self.l_chunk)
        tok = np.zeros((b_pad, l_pad), dtype=np.int8)
        tok[:b, :seq_len] = tokens  # contiguous cast-store
        lengths_p = np.zeros(b_pad, dtype=np.int32)
        lengths_p[:b] = lengths
        return self._staged(self._dev(tok, 0), lengths_p, b)

    def stage_fasta(self, db: FastaDatabase) -> StagedDatabase:
        tokens, lengths = db.encode()
        return self.stage(tokens, lengths)

    def stage_device(
        self, tokens_i8: jax.Array, lengths: np.ndarray, num_sequences: int | None = None
    ) -> StagedDatabase:
        """Stage an ALREADY-ON-DEVICE token block (no host upload):
        ``tokens_i8`` is int8 [B_pad, L_pad] with B_pad a multiple of the
        batch bucket and L_pad of l_chunk; ``lengths`` is the host-side
        [B_pad] array. Used by the benchmark (device-generated corpora)
        and by callers slicing an existing staged database."""
        b_pad, l_pad = tokens_i8.shape
        assert b_pad % self._b_gran() == 0 and l_pad % self.l_chunk == 0
        lengths_p = np.asarray(lengths, dtype=np.int32)
        assert lengths_p.shape == (b_pad,)
        if self.mesh is not None:
            tokens_i8 = self._dev(tokens_i8, 0)  # reshard over db
        return self._staged(
            tokens_i8, lengths_p,
            num_sequences if num_sequences is not None else b_pad,
        )

    def stage_bucketed(
        self,
        tokens: np.ndarray,
        lengths: np.ndarray,
        waste_factor: float = 0.25,
    ) -> "BucketedDatabase":
        """Stage a ragged batch as length-sorted buckets (see
        :class:`BucketedDatabase`). ``waste_factor`` caps per-sequence
        padding: a bucket closes when the next (longer) sequence's
        rounded length exceeds the bucket's shortest by more than this
        fraction."""
        tokens = np.asarray(tokens)
        lengths = np.asarray(lengths, dtype=np.int32)
        b = tokens.shape[0]
        order = np.argsort(lengths, kind="stable")

        buckets: list[StagedDatabase] = []
        bucket_order: list[np.ndarray] = []
        start = 0
        while start < b:
            lo = max(int(lengths[order[start]]), 1)
            cap = _round_up(max(int(lo * (1.0 + waste_factor)), 1), self.l_chunk)
            end = start
            while end < b and lengths[order[end]] <= cap:
                end += 1
            idx = order[start:end]
            l_max = max(int(lengths[idx].max()), 1)  # stage() rounds up
            buckets.append(self.stage(tokens[idx, :l_max], lengths[idx]))
            bucket_order.append(idx)
            start = end
        return BucketedDatabase(
            buckets=buckets, order=bucket_order, num_sequences=b
        )

    def scan_bucketed(
        self, profile: MSVProfile, bucketed: "BucketedDatabase"
    ) -> np.ndarray:
        """Score every sequence of a bucketed database -> f32 [B] in the
        ORIGINAL order."""
        out = np.empty(bucketed.num_sequences, dtype=np.float32)
        for staged, idx in zip(bucketed.buckets, bucketed.order):
            out[idx] = np.asarray(self.scan(profile, staged))
        return out

    # -- MSV -------------------------------------------------------------
    def _impl_for(self, profile: MSVProfile) -> str:
        """The CUDA kernels are compiled for up to msv_cuda.Q_MAX states
        per lane; a wider profile runs on XLA (a fixed rule of shape)."""
        if self.msv_impl == "cuda" and msv_cuda.states_per_lane(profile.num_states) > msv_cuda.Q_MAX:
            logger.info(
                "%s: %d states exceed the CUDA kernel's %d; using XLA",
                profile.name, profile.num_states, msv_cuda.WARP * msv_cuda.Q_MAX,
            )
            return "xla"
        return self.msv_impl

    def _msv_fn(self, impl: str):
        """fn(table, tokens_i8, lengths, tr_rows, consts) -> [P, B_pad]:
        the CUDA kernel or its XLA reference, db-sharded on a mesh."""
        if self.mesh is not None:
            from .parallel.database import make_db_scanner

            return make_db_scanner(self.mesh, impl)
        return msv_cuda.msv_packed if impl == "cuda" else msv_cuda.msv_packed_reference

    def _scan_group(self, impl: str, profiles: list, staged: StagedDatabase) -> jax.Array:
        """Scores [P, B_pad] of profiles that share one packed width."""
        q = max(msv_cuda.states_per_lane(p.num_states) for p in profiles)
        table = np.stack([msv_cuda.pack_table(p.scores_real, q) for p in profiles])
        consts = np.array(
            [[p.tr_B_Mk, p.tr_E_C, p.tr_E_J] for p in profiles], dtype=np.float32
        )
        return self._msv_fn(impl)(
            jnp.asarray(table), staged.tokens_i8, staged.lengths,
            staged.tr_rows, jnp.asarray(consts),
        )

    def scan(self, profile: MSVProfile, staged: StagedDatabase) -> jax.Array:
        """Score every staged sequence against one profile -> f32 [B]."""
        key = (id(profile), "msv")
        dev = self._cache_get(key, profile)
        if dev is None:
            q = msv_cuda.states_per_lane(profile.num_states)
            dev = self._cache_put(key, profile, (
                jnp.asarray(msv_cuda.pack_table(profile.scores_real, q)[None]),
                jnp.asarray(np.array(
                    [[profile.tr_B_Mk, profile.tr_E_C, profile.tr_E_J]],
                    dtype=np.float32,
                )),
            ))
        out = self._msv_fn(self._impl_for(profile))(
            dev[0], staged.tokens_i8, staged.lengths, staged.tr_rows, dev[1]
        )
        return out[0, : staged.num_sequences]

    def scan_filter(self, profile: MSVProfile, staged: StagedDatabase) -> jax.Array:
        """MSV prefilter scores, an upper bound on :meth:`scan`. An f32
        lookup costs the GPU the same as a rounded one, so the filter is
        the exact scan and its survivors need no rescore."""
        return self.scan(profile, staged)

    def scan_many_bucketed(
        self,
        profiles: list[MSVProfile],
        bucketed: "BucketedDatabase",
        mode: str = "exact",
    ) -> dict[str, np.ndarray]:
        """Stacked multi-profile sweep over a length-bucketed database:
        one stacked call per (profile width x length bucket); results
        scattered back to the original sequence order."""
        results = {
            p.name: np.empty(bucketed.num_sequences, dtype=np.float32)
            for p in profiles
        }
        for staged, idx in zip(bucketed.buckets, bucketed.order):
            sub = self.scan_many(profiles, staged, mode=mode)
            for name, scores in sub.items():
                results[name][idx] = scores
        return results

    def scan_many(
        self,
        profiles: list[MSVProfile],
        staged: StagedDatabase,
        mode: str = "exact",
    ) -> dict[str, np.ndarray]:
        """Sweep: scan the staged database against many profiles.

        Profiles are grouped by packed width (states per lane) and each
        group runs as ONE stacked call — the 24-profile reference sweep
        costs one call per width instead of 24. ``mode="filter"`` is
        accepted for the prefilter's callers and is the exact scan
        (:meth:`scan_filter`).
        """
        assert mode in ("exact", "filter")
        groups: dict[tuple, list[MSVProfile]] = {}
        for p in profiles:
            key = (self._impl_for(p), msv_cuda.states_per_lane(p.num_states))
            groups.setdefault(key, []).append(p)
        results: dict[str, np.ndarray] = {}
        for (impl, _q), group in sorted(groups.items()):
            out = np.asarray(self._scan_group(impl, group, staged))
            for p, scores in zip(group, out[:, : staged.num_sequences]):
                results[p.name] = scores
        return results

    # -- Viterbi / Forward -------------------------------------------------
    def scan_p7(self, p7, staged: StagedDatabase, stage: str = "viterbi") -> jax.Array:
        """Viterbi/Forward scores of every staged sequence -> f32 [B],
        from the device-resident tokens (XLA lax.scan, ops.p7_scan)."""
        from .ops import p7_scan

        assert stage in ("viterbi", "forward")
        key = (id(p7), "p7")
        packed = self._cache_get(key, p7)
        if packed is None:
            packed = self._cache_put(key, p7, p7_scan.pack_profile(p7))
        args = (
            *packed, staged.tokens_i8, staged.lengths,
            staged.tr_rows[0], staged.tr_rows[1],
        )
        if self.mesh is not None:
            from .parallel.database import make_db_p7_scanner

            out = make_db_p7_scanner(self.mesh, stage)(*args)
        else:
            fn = p7_scan.viterbi_jit if stage == "viterbi" else p7_scan.forward_jit
            out = fn(*args)
        return out[: staged.num_sequences]

    def scan_p7_filter(self, p7, staged: StagedDatabase) -> jax.Array:
        """Viterbi prefilter scores: the exact Viterbi score, which is its
        own upper bound, so the filter's survivors need no rescore."""
        return self.scan_p7(p7, staged, stage="viterbi")


@dataclasses.dataclass
class BucketedDatabase:
    """A ragged database staged as length-sorted buckets.

    Real protein databases are heavily length-skewed (most sequences a
    few hundred aa, a tail out to tens of thousands); padding everything
    to the global maximum wastes the DP grid on padding cells. Buckets
    bound that waste: sequences are sorted by length, grouped so no
    bucket pads a sequence by more than ``waste_factor`` of its rounded
    length, and each bucket is staged separately. Scans run per bucket
    and results are scattered back to the original order.
    """

    buckets: list[StagedDatabase]
    order: list[np.ndarray]  # original indices per bucket
    num_sequences: int

    @property
    def padded_cells_saved(self) -> float:
        """Fraction of padded residues avoided vs single-bucket staging."""
        if not self.buckets:
            return 0.0
        per_bucket = sum(
            s.tokens_i8.shape[1] * s.num_sequences for s in self.buckets
        )
        max_l = max(s.tokens_i8.shape[1] for s in self.buckets)
        single = max_l * self.num_sequences
        return 1.0 - per_bucket / single if single else 0.0


@dataclasses.dataclass
class SearchResult:
    """Outcome of the staged acceleration pipeline for one profile."""

    msv_scores: np.ndarray  # [B] f32 (all sequences)
    msv_pvalues: np.ndarray
    viterbi_scores: np.ndarray  # [B] f32, NaN where not computed
    viterbi_pvalues: np.ndarray
    forward_scores: np.ndarray  # [B] f32, NaN where not computed
    forward_pvalues: np.ndarray
    passed_msv: np.ndarray  # [B] bool
    passed_viterbi: np.ndarray
    passed_forward: np.ndarray

    @property
    def hits(self) -> np.ndarray:
        return np.flatnonzero(self.passed_forward)


class SearchPipeline:
    """hmmsearch-style acceleration cascade: MSV -> Viterbi -> Forward.

    The reference implements only the MSV stage of this pipeline
    (SURVEY.md scope note); the full cascade is this engine's extension,
    using HMMER3's standard stage thresholds. Each stage only rescores
    the survivors of the previous one.
    """

    @classmethod
    def from_config(cls, config, scanner: MSVScanner | None = None) -> "SearchPipeline":
        return cls(
            scanner=scanner or MSVScanner.from_config(config),
            msv_p=config.msv_p,
            viterbi_p=config.viterbi_p,
            forward_p=config.forward_p,
        )

    def __init__(
        self,
        scanner: MSVScanner | None = None,
        msv_p: float = 0.02,
        viterbi_p: float = 1e-3,
        forward_p: float = 1e-5,
        fast_msv: bool = False,
        fast_viterbi: bool = False,
    ):
        self.scanner = scanner or MSVScanner()
        self.msv_p = msv_p
        self.viterbi_p = viterbi_p
        self.forward_p = forward_p
        # fast_msv / fast_viterbi: score the stage with the scanner's
        # prefilter (scan_filter / scan_p7_filter). Both return exact
        # scores, so no survivor is rescored and the hits are identical
        self.fast_msv = fast_msv
        self.fast_viterbi = fast_viterbi
        # derived MSVProfile/P7Profile per hmm object (pinned, same
        # stale-id discipline as MSVScanner._profile_cache): streamed
        # scans/sweeps call search() once per batch, and handing the
        # scanner a FRESH derived profile each call would grow its
        # id-keyed device caches by one pinned entry (profile pack +
        # device arrays) per batch — an unbounded leak that also
        # re-uploads the profile every batch. LRU-bounded like
        # MSVScanner._profile_cache: sweeps over thousands of profiles
        # must not pin every derived pack forever
        self._derived_cache: collections.OrderedDict = collections.OrderedDict()

    _DERIVED_MAX = 32

    def _derived(self, hmm):
        hit = self._derived_cache.get(id(hmm))
        if hit is not None and hit[0] is hmm:
            self._derived_cache.move_to_end(id(hmm))
            return hit[1], hit[2]
        from .models.p7 import P7Profile

        msvp = MSVProfile.from_profile(hmm)
        p7 = P7Profile.from_profile(hmm)
        self._derived_cache[id(hmm)] = (hmm, msvp, p7)
        while len(self._derived_cache) > self._DERIVED_MAX:
            self._derived_cache.popitem(last=False)
        return msvp, p7

    def _msv(self, profile, staged) -> np.ndarray:
        scan = self.scanner.scan_filter if self.fast_msv else self.scanner.scan
        # copy: np.asarray of a jax.Array is a read-only view
        return np.array(scan(profile, staged))

    def search(self, hmm, staged: StagedDatabase, tokens: np.ndarray, lengths: np.ndarray) -> SearchResult:
        """Run the cascade. ``hmm`` is a ProfileHMM; ``tokens``/``lengths``
        are the host-side arrays used to rescore survivor subsets."""
        msv_profile, p7 = self._derived(hmm)
        msv_scores = self._msv(msv_profile, staged)
        return self._finish_cascade(hmm, p7, msv_scores, tokens, lengths)

    def search_bucketed(
        self, hmm, bucketed, tokens: np.ndarray, lengths: np.ndarray
    ) -> SearchResult:
        """The cascade over a length-bucketed staging
        (MSVScanner.stage_bucketed): the MSV stage runs per bucket,
        bounding ragged-padding waste on length-skewed databases; the
        p7 stages restage survivors compactly exactly as in search()."""
        msv_profile, p7 = self._derived(hmm)
        msv_scores = np.empty(bucketed.num_sequences, dtype=np.float32)
        for staged, idx in zip(bucketed.buckets, bucketed.order):
            msv_scores[idx] = self._msv(msv_profile, staged)
        return self._finish_cascade(hmm, p7, msv_scores, tokens, lengths)

    def _finish_cascade(
        self, hmm, p7, msv_scores: np.ndarray,
        tokens: np.ndarray, lengths: np.ndarray,
    ) -> SearchResult:
        """Viterbi/Forward rescoring of MSV survivors (shared by the
        staged and bucketed entry points)."""
        from .models import stats

        b = len(msv_scores)
        msv_pv = stats.msv_pvalue(msv_scores, hmm)
        passed_msv = msv_pv <= self.msv_p

        vit_scores = np.full(b, np.nan, dtype=np.float32)
        vit_pv = np.full(b, np.nan)
        fwd_scores = np.full(b, np.nan, dtype=np.float32)
        fwd_pv = np.full(b, np.nan)
        passed_vit = np.zeros(b, dtype=bool)
        passed_fwd = np.zeros(b, dtype=bool)

        def _p7_stage(sel: np.ndarray, stage: str) -> np.ndarray:
            # survivors restage compactly (mesh-sharded when the scanner
            # carries a mesh)
            l_max = max(int(lengths[sel].max()), 1)
            sub = self.scanner.stage(tokens[sel, :l_max], lengths[sel])
            if stage == "viterbi" and self.fast_viterbi:
                return np.asarray(self.scanner.scan_p7_filter(p7, sub))
            return np.asarray(self.scanner.scan_p7(p7, sub, stage=stage))

        idx = np.flatnonzero(passed_msv)
        if idx.size:
            vs = _p7_stage(idx, "viterbi")
            vit_scores[idx] = vs
            vit_pv[idx] = stats.viterbi_pvalue(vs, hmm)
            passed_vit[idx] = vit_pv[idx] <= self.viterbi_p

            idx2 = np.flatnonzero(passed_vit)
            if idx2.size:
                fs = _p7_stage(idx2, "forward")
                fwd_scores[idx2] = fs
                fwd_pv[idx2] = stats.forward_pvalue(fs, hmm)
                passed_fwd[idx2] = fwd_pv[idx2] <= self.forward_p

        return SearchResult(
            msv_scores=msv_scores,
            msv_pvalues=msv_pv,
            viterbi_scores=vit_scores,
            viterbi_pvalues=vit_pv,
            forward_scores=fwd_scores,
            forward_pvalues=fwd_pv,
            passed_msv=passed_msv,
            passed_viterbi=passed_vit,
            passed_forward=passed_fwd,
        )
