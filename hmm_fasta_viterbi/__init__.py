"""hmm_fasta_viterbi — a profile-HMM sequence-scan engine in JAX, with a
CUDA MSV kernel for NVIDIA Hopper.

A JAX / XLA framework with the capabilities of
the reference C++/OpenCL MSV engine (IvanTyulyandin/HMM_FASTA_Viterbi):
HMMER3 ``.hmm`` + protein FASTA parsing, score pre-expansion, and the
MSV / Viterbi / Forward / Backward dynamic-programming stages with
posterior decoding — plus batched, multi-device, and long-sequence-sharded
execution that the reference lacks.
"""

from .io.alphabet import AMINO_ACIDS, BACKGROUND_FREQUENCIES, NUM_AMINO_ACIDS
from .io.fastaio import FastaDatabase, FastaRecord, parse_fasta, parse_fasta_text
from .io.hmmio import HMMParseError, ProfileHMM, parse_hmm, parse_hmm_text
from .models.msv import MSVProfile, expand_msv_scores, length_transitions, msv_transitions
from .ops.reference import (
    backward_oracle,
    msv_oracle,
    msv_oracle_batch,
    posterior_match,
)

__version__ = "0.1.0"

__all__ = [
    "backward_oracle",
    "posterior_match",
    "AMINO_ACIDS",
    "BACKGROUND_FREQUENCIES",
    "NUM_AMINO_ACIDS",
    "FastaDatabase",
    "FastaRecord",
    "parse_fasta",
    "parse_fasta_text",
    "HMMParseError",
    "ProfileHMM",
    "parse_hmm",
    "parse_hmm_text",
    "MSVProfile",
    "expand_msv_scores",
    "length_transitions",
    "msv_transitions",
    "msv_oracle",
    "msv_oracle_batch",
    "__version__",
]
