"""SAM header generation (bwa_print_sam_hdr, bwa.cpp:523-565)."""

from __future__ import annotations

from ..index.fmindex import FMIndex


def sam_header(fm: FMIndex, hdr_line: str | None = None,
               pg_line: str | None = None) -> str:
    out = []
    n_sq = 0
    if hdr_line:
        for ln in hdr_line.split("\n"):
            if ln.startswith("@SQ\t"):
                n_sq += 1
    if n_sq == 0:
        for a in fm.bns.anns:
            out.append(f"@SQ\tSN:{a.name}\tLN:{a.length}")
            if a.is_alt:
                out[-1] += "\tAH:*"
    if hdr_line:
        out.append(hdr_line)
    if pg_line:
        out.append(pg_line)
    return "\n".join(out) + "\n" if out else ""


def pg_line(argv: list[str], version: str) -> str:
    cl = " ".join(argv)
    return (f"@PG\tID:bwa-mem2-tpu\tPN:bwa-mem2-tpu\tVN:{version}\tCL:{cl}")
