"""MSV (Multiple Segment Viterbi) filter model: score pre-expansion and
per-sequence special-state transitions.

Numeric parity with the reference engine (algorithms/MSV_HMM.cpp:35-64),
all in float32:

* emission log-odds ``log(match_em[k][aa] / bg[aa])`` (MSV_HMM.cpp:40-45);
* ``tr_B_Mk = log(2 / (m * (m + 1)))`` with ``m = model_length = LENG+1``
  — the reference's deliberate off-by-one vs HMMER (SURVEY.md quirk 2);
* ``nu = 2.0`` expected hits: ``tr_E_C = log((nu-1)/nu)``,
  ``tr_E_J = log(1/nu)`` (MSV_HMM.cpp:47-53);
* length-dependent ``tr_loop = log(L/(L+3))``, ``tr_move = log(3/(L+3))``
  (MSV_HMM.cpp:59-64).

Design departure: the device path consumes a *finite* transposed score
matrix ``scores_real [20, m-1]`` covering only real match states (the
dummy M0 column is ``log(0/bg) = -inf`` and provably never contributes —
dp[:, 0] stays -inf in the reference recurrence).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.alphabet import BACKGROUND_FREQUENCIES, NUM_AMINO_ACIDS
from ..io.hmmio import ProfileHMM

NEG_INF = np.float32(-np.inf)

# nu — expected number of hits (reference: MSV_HMM.cpp:47-49, after
# hmmer generic_msv.c).
NU = np.float32(2.0)


def expand_msv_scores(profile: ProfileHMM) -> np.ndarray:
    """Pre-expand emission log-odds: ``scores[aa, k] = log(match[k][aa]/bg[aa])``.

    Shape [20, m] float32, matching the reference's transposed flattened
    layout (MSV_HMM.cpp:40-45). Column 0 (dummy M0) is -inf.
    """
    m = profile.model_length
    assert profile.match_emissions.shape == (m, NUM_AMINO_ACIDS)
    with np.errstate(divide="ignore"):
        scores = np.log(
            profile.match_emissions.astype(np.float32)
            / BACKGROUND_FREQUENCIES[None, :]
        ).astype(np.float32)
    return np.ascontiguousarray(scores.T)  # [20, m]


@dataclasses.dataclass(frozen=True)
class MSVTransitions:
    """Length-independent special-state transitions of one profile."""

    tr_B_Mk: np.float32
    tr_E_C: np.float32
    tr_E_J: np.float32


def msv_transitions(model_length: int) -> MSVTransitions:
    """Constant transitions (reference: MSV_HMM.cpp:51-53).

    Note ``model_length`` here is the reference's ``base_hmm.model_length``
    = LENG+1, used directly in the B->Mk formula (quirk 2 preserved).
    """
    m = model_length
    tr_B_Mk = np.log(np.float32(2.0) / np.float32(m * (m + 1)))
    tr_E_C = np.log((NU - np.float32(1.0)) / NU)
    tr_E_J = np.log(np.float32(1.0) / NU)
    return MSVTransitions(np.float32(tr_B_Mk), np.float32(tr_E_C), np.float32(tr_E_J))


def length_transitions(length: int | np.ndarray):
    """Per-sequence-length loop/move transitions (MSV_HMM.cpp:59-64).

    ``length`` is the residue count L (the reference's ``seq.size()-1``,
    sentinel stripped). Accepts scalars or arrays (vectorized for batch).
    Returns float32 ``(tr_loop, tr_move)``; L=0 yields ``(-inf, 0)``.
    """
    size = np.asarray(length).astype(np.float32)
    with np.errstate(divide="ignore"):
        tr_loop = np.log(size / (size + np.float32(3.0))).astype(np.float32)
    tr_move = np.log(np.float32(3.0) / (size + np.float32(3.0))).astype(np.float32)
    return tr_loop, tr_move


@dataclasses.dataclass
class MSVProfile:
    """Device-ready MSV scoring profile.

    * ``scores`` — [20, m] float32 with -inf M0 column (host/oracle layout)
    * ``scores_real`` — [20, m-1] float32, finite, for the device paths
    * transitions per :func:`msv_transitions`
    """

    name: str
    model_length: int  # m = LENG + 1
    scores: np.ndarray
    scores_real: np.ndarray
    tr_B_Mk: np.float32
    tr_E_C: np.float32
    tr_E_J: np.float32
    # Gumbel calibration carried through for P-/E-values (models.stats)
    stats_local_msv_mu: float = 0.0
    stats_local_msv_lambda: float = 0.0

    @classmethod
    def from_profile(cls, profile: ProfileHMM) -> "MSVProfile":
        scores = expand_msv_scores(profile)
        tr = msv_transitions(profile.model_length)
        return cls(
            name=profile.name,
            model_length=profile.model_length,
            scores=scores,
            scores_real=np.ascontiguousarray(scores[:, 1:]),
            tr_B_Mk=tr.tr_B_Mk,
            tr_E_C=tr.tr_E_C,
            tr_E_J=tr.tr_E_J,
            stats_local_msv_mu=profile.stats_local_msv_mu,
            stats_local_msv_lambda=profile.stats_local_msv_lambda,
        )

    @property
    def num_states(self) -> int:
        """Number of real match states (m - 1 = LENG)."""
        return self.model_length - 1
