"""Per-set input checks: a malformed read set is refused with one line, and
in a `-l` run it is quarantined while the other sets complete.

Counterpart of `abpoa_tpu/resilience/quarantine.py:19-70` (the checks of
`validate_records` and the stderr line of `quarantine_set`); the JAX
package's fault-ledger records stay with ROADMAP.md queue A, item 10.
"""
from __future__ import annotations

import os
import sys


class PoisonedSetError(ValueError):
    """A read set rejected by input validation (quarantinable)."""


# what a set's boundary turns into a quarantine instead of raising:
# malformed input and I/O errors. Anything else is a bug and propagates.
QUARANTINE_EXCEPTIONS = (PoisonedSetError, OSError, EOFError,
                         UnicodeDecodeError)


def max_reads_per_set() -> int:
    """The cap on reads per set (ABPOA_TPU_MAX_READS, as in the JAX
    package)."""
    return int(os.environ.get("ABPOA_TPU_MAX_READS", "100000"))


def validate_records(records) -> None:
    """Raise PoisonedSetError for a set with no records, more reads than
    the cap, an empty sequence or a FASTQ quality of another length."""
    if not records:
        raise PoisonedSetError("no sequence records parsed "
                               "(empty or malformed file)")
    cap = max_reads_per_set()
    if len(records) > cap:
        raise PoisonedSetError(
            f"{len(records)} reads exceeds the per-set cap of {cap} "
            "(ABPOA_TPU_MAX_READS)")
    for i, rec in enumerate(records):
        if not rec.seq:
            raise PoisonedSetError(
                f"record {i} ({rec.name or 'unnamed'}): empty sequence")
        if rec.qual is not None and len(rec.qual) != len(rec.seq):
            raise PoisonedSetError(
                f"record {i} ({rec.name or 'unnamed'}): FASTQ quality "
                f"length {len(rec.qual)} != sequence length {len(rec.seq)} "
                "(truncated record?)")


def quarantine_set(index: int, label: str, exc: Exception) -> None:
    """One quarantined set: a single line on stderr."""
    print(f"[abpoa-tpu] set {index} ({label}) quarantined: "
          f"{type(exc).__name__}: {exc}", file=sys.stderr)
