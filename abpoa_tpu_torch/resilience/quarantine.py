"""Per-set input checks: a malformed read set is refused with one line, and
in a `-l` run or `msa_batch` it is quarantined while the other sets
complete.

Counterpart of `abpoa_tpu/resilience/quarantine.py` (the checks of
`validate_records` with its `poison_set` injection point, and
`quarantine_set` with its fault record in the run report).
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


def validate_records(records, abpt=None, label: str = "") -> None:
    """Raise PoisonedSetError for a set with no records, more reads than
    the cap, an empty sequence or a FASTQ quality of another length, or
    where the `poison_set` injector fires. `abpt` and `label` are the JAX
    signature's; the checks read neither."""
    from .inject import check_poison_set
    check_poison_set()
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
    """One quarantined set: the run report's `poisoned_set` fault record
    keyed by set index, the `quarantine.sets` count, and a single line on
    stderr (abpoa_tpu/resilience/quarantine.py:63)."""
    from ..obs import count, report
    count("quarantine.sets")
    reason = f"{type(exc).__name__}: {exc}"
    report().record_fault("poisoned_set", set_index=index,
                          detail=reason[:300], action="quarantined")
    print(f"[abpoa-tpu] set {index} ({label}) quarantined: {reason}",
          file=sys.stderr)
