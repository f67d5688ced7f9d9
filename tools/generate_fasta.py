#!/usr/bin/env python
"""Random protein FASTA corpus generator.

Capability parity with the reference generator
(FASTA_files/random_FASTA_generator.py: 3 records x 3500 uniform residues
wrapped at 70 columns) plus seeding and CLI parameters; vectorized.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from hmm_fasta_viterbi.io.alphabet import AMINO_ACIDS  # noqa: E402
from hmm_fasta_viterbi.io.fastaio import FastaRecord, write_fasta  # noqa: E402


def generate_records(count: int, length: int, seed: int | None = None) -> list[FastaRecord]:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)
    records = []
    for i in range(count):
        seq = alphabet[rng.integers(0, len(alphabet), size=length)].tobytes().decode()
        records.append(FastaRecord(header=f" random {i}", sequence=seq))
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="random_FASTA.fsa")
    ap.add_argument("--count", type=int, default=3)
    ap.add_argument("--length", type=int, default=3500)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--width", type=int, default=70)
    args = ap.parse_args()

    write_fasta(args.out, generate_records(args.count, args.length, args.seed), args.width)
    print(f"wrote {args.count} x {args.length} aa to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
