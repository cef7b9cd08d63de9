"""FASTA/FASTQ streaming reader (gzip-transparent).

Same record model as abPOA's kseq.h reader: name, comment, seq, qual.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Optional


@dataclass
class SeqRecord:
    name: str
    comment: str
    seq: str
    qual: Optional[str] = None


def _open(path: str):
    with open(path, "rb") as fp:
        magic = fp.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def iter_fastx_handle(fp) -> Iterator[SeqRecord]:
    """Parse FASTA/FASTQ records from an open text handle. CRLF line endings
    are stripped; a FASTQ record truncated at EOF yields its partial fields."""
    name = comment = None
    seq_parts: List[str] = []
    in_qual = False
    for line in fp:
        line = line.rstrip("\r\n")
        if not line and not in_qual:
            continue
        if line.startswith(">") or (line.startswith("@") and not in_qual and name is None):
            if name is not None:
                yield SeqRecord(name, comment or "", "".join(seq_parts), None)
            head = line[1:].split(None, 1)
            name = head[0] if head else ""
            comment = head[1] if len(head) > 1 else ""
            seq_parts, in_qual = [], False
            if line.startswith("@"):
                # FASTQ: strict 4-line records
                seq = fp.readline().rstrip("\r\n")
                fp.readline()  # '+'
                qual = fp.readline().rstrip("\r\n")
                yield SeqRecord(name, comment or "", seq, qual)
                name = None
        else:
            seq_parts.append(line)
    if name is not None:
        yield SeqRecord(name, comment or "", "".join(seq_parts), None)


def read_fastx(path: str) -> List[SeqRecord]:
    """The records of `path`, timed as the run report's `fastx_parse`
    phase (abpoa_tpu/io/fastx.py:75)."""
    from ..obs import phase
    with phase("fastx_parse"), _open(path) as fp:
        return list(iter_fastx_handle(fp))


def read_fastx_text(text: str) -> List[SeqRecord]:
    """The records of in-memory FASTA/FASTQ text (a server request's
    body): the same parser, no file."""
    import io
    return list(iter_fastx_handle(io.StringIO(text)))
