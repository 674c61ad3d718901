"""EFASTA — FASTA extended with {alt1,alt2} ambiguity blocks.

The reference's final assembly format (ref: src/efasta/EfastaTools.{h,cc};
outputs final.contigs.efasta / final.assembly.efasta): plain bases plus
brace blocks recording unresolved (often diploid) alternatives. This module
is format-compatible so outputs can be diffed against reference runs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

from allpathslg_tpu_torch.dtypes.reads import string_from_codes, codes_from_string

# an efasta record is a list of segments: str (plain bases) or
# tuple of alternatives (each a str)
Segment = Union[str, Tuple[str, ...]]


def render(segments: Sequence[Segment]) -> str:
    out = []
    for seg in segments:
        if isinstance(seg, str):
            out.append(seg)
        else:
            out.append("{" + ",".join(seg) + "}")
    return "".join(out)


def parse(text: str) -> List[Segment]:
    segs: List[Segment] = []
    i = 0
    buf = []
    while i < len(text):
        c = text[i]
        if c == "{":
            if buf:
                segs.append("".join(buf))
                buf = []
            j = text.index("}", i)
            segs.append(tuple(text[i + 1 : j].split(",")))
            i = j + 1
        else:
            buf.append(c)
            i += 1
    if buf:
        segs.append("".join(buf))
    return segs


def flatten_first(segments: Sequence[Segment]) -> str:
    """EFASTA → FASTA by taking the first alternative (the reference's
    convention for final.contigs.fasta)."""
    out = []
    for seg in segments:
        out.append(seg if isinstance(seg, str) else seg[0])
    return "".join(out)


def total_length(segments: Sequence[Segment]) -> int:
    return len(flatten_first(segments))


def ambiguities(segments: Sequence[Segment]) -> int:
    return sum(1 for s in segments if not isinstance(s, str))


def write_efasta(path: str, records: Sequence[Tuple[str, Sequence[Segment]]],
                 width: int = 80) -> None:
    with open(path, "w") as f:
        for name, segs in records:
            f.write(f">{name}\n")
            s = render(segs)
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")


def read_efasta(path: str) -> List[Tuple[str, List[Segment]]]:
    out = []
    name = None
    chunks: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, parse("".join(chunks))))
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        out.append((name, parse("".join(chunks))))
    return out
