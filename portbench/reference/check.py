"""The comparison that decides `correct`: the program's SAM records of a
sample of the window's reads, judged against the genome and the reads'
true origins by plain code.

For every mapped record of a sampled read:
- `tag_bad` counts records that do not hold together: a CIGAR whose read
  length is not the SEQ's, a SEQ that is not the read as generated (in the
  record's orientation, less its hard clips), or NM / MD tags other than
  what the CIGAR at POS gives against the genome (worked out here as bwa's
  `bwa_gen_cigar2` writes them).  Limit 0.
- `over_best` counts records whose AS exceeds the best local score of the
  whole read (`sw.best_local`) in a stretch around the record's own
  alignment: no alignment there can score more.  Limit 0.

For every sampled read:
- `short_share` is the share whose primary record scores (AS; 0 when
  unmapped) below `1 - SHORTFALL` of the best local score of the read at
  its true origin.  A read that seeding misses, that is placed at a worse
  locus, or extended short, or a mate that rescue should have placed,
  lands here.

For every sampled pair (mates are judged by their primary records):
- `pair_bad` counts primary records whose mate fields disagree with the
  mate's primary record as bwa's `mem_aln2sam` writes them: flags 0x1,
  0x8 and 0x20, RNEXT `=`, PNEXT the mate's POS, and TLEN from both
  records' 5' ends; with one mate unmapped, 0x8 on the mapped one and
  the unmapped one placed at its mate.  Limit 0.
- `pair_lost` counts pairs whose two primaries both sit at their true
  origin (strand as generated, over at least half of the source span)
  and whose fragment lies within `frag_band` (two standard deviations of
  the mix's mean), but are not flagged a proper pair (0x2), or whose
  |TLEN| is not the fragment's length less the two 5' clips (one base of
  slack for an indel that a clip covers).  bwa calls a pair proper only
  inside the insert bounds it estimates from each chunk (`mem_pestat`:
  the wider of the quartiles +- 3 IQR and the mean +- 4 sd), which a
  fragment in the band never leaves.  Limit 0.

For every mate-rescue problem the window's chunks posed for a sampled
pair (the read, the stretch of genome, the kernel's score, kept as the
window ran):
- `rescue_bad` counts problems whose score is not the best local score
  of the mate (reverse-complemented where the problem says so) against
  that stretch, taken from the genome here.  Limit 0.

A record whose stretch of genome holds an N is not judged (`skipped`): the
program's packed genome holds random bases there.

Imports nothing of the program.
"""

from __future__ import annotations

import re

import numpy as np

from .sw import best_local

SHORTFALL = 0.10          # a primary record below 90 % of the best is short
OWN_MARGIN = 16           # bases around a record's own alignment
TRUE_MARGIN_MIN = 50      # bases around a read's source span, at least,
TRUE_MARGIN_SHARE = 0.05  # or this share of the span
CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
ENC = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ENC[_c] = _i
    ENC[ord(chr(_c).lower())] = _i
INT2BASE = "ACGTN"


def rc(c: np.ndarray) -> np.ndarray:
    return (3 - c[::-1]).astype(np.uint8)


def parse_records(sam: str) -> list[dict]:
    out = []
    for line in sam.splitlines():
        if not line:
            continue
        f = line.split("\t")
        if len(f) < 11:
            out.append({"bad": "fields"})
            continue
        tags = {}
        for x in f[11:]:
            p = x.split(":", 2)
            if len(p) == 3:
                tags[p[0]] = p[2]
        out.append({"name": f[0], "flag": int(f[1]), "rname": f[2],
                    "pos": int(f[3]), "cigar": f[5], "rnext": f[6],
                    "pnext": int(f[7]), "tlen": int(f[8]), "seq": f[9],
                    "tags": tags})
    return out


def cigar_ops(cigar: str) -> list[tuple[int, str]]:
    ops = [(int(n), op) for n, op in CIGAR_RE.findall(cigar)]
    if "".join(f"{n}{op}" for n, op in ops) != cigar:
        raise ValueError(cigar)
    return ops


def md_nm(ops, query: np.ndarray, ref: np.ndarray) -> tuple[str, int, int]:
    """(MD, NM, reference length) of an alignment, as bwa writes them;
    `query` is the SEQ's codes, `ref` the genome from POS on."""
    md, u, y, nm = [], 0, 0, 0
    core = [(n, op) for n, op in ops if op not in "SH"]
    lead = [(n, op) for n, op in ops if op != "H"]
    x = lead[0][0] if lead and lead[0][1] == "S" else 0
    for k, (n, op) in enumerate(core):
        if op in "M=X":
            for i in range(n):
                if query[x + i] != ref[y + i]:
                    md.append(f"{u}{INT2BASE[ref[y + i]]}")
                    nm += 1
                    u = 0
                else:
                    u += 1
            x += n
            y += n
        elif op == "D":
            if 0 < k < len(core) - 1:
                md.append(f"{u}^" + "".join(INT2BASE[c]
                                            for c in ref[y:y + n]))
                u = 0
            nm += n
            y += n
        elif op == "I":
            x += n
            nm += n
    md.append(str(u))
    return "".join(md), nm, y


def clipped(ops) -> int:
    """Bases soft- or hard-clipped at the start of `ops`."""
    n = 0
    for k, op in ops:
        if op not in "SH":
            break
        n += k
    return n


def place(rec: dict, ops) -> None:
    """Set a mapped record's 0-based start `p0`, its reference length
    `rlen`, its 5' end `end5` (the position bwa's TLEN takes) and the
    bases clipped there, `clip5`."""
    rec["p0"] = rec["pos"] - 1
    rec["rlen"] = sum(n for n, op in ops if op in "MD=XN")
    if rec["flag"] & 16:
        rec["end5"] = rec["p0"] + sum(n for n, op in ops if op in "MD") - 1
        rec["clip5"] = clipped(ops[::-1])
    else:
        rec["end5"], rec["clip5"] = rec["p0"], clipped(ops)


def bwa_tlen(p: dict, m: dict) -> int:
    """TLEN of record p whose mate's primary is m (mem_aln2sam)."""
    p0, p1 = p["end5"], m["end5"]
    return -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))


def judge_pair(r: list[dict], prim: list[dict | None],
               band: tuple[float, float] = (0, np.inf)
               ) -> tuple[int, int, int]:
    """(records with wrong mate fields, 1 if the pair sits at its true
    origin with a fragment inside `band`, 1 if it does and is not a proper
    pair of the fragment's length).  r: the two mates' truth; prim: their
    primary records."""
    if any(p is None for p in prim):
        return 0, 0, 0           # a malformed primary is tag_bad already
    mapped = [not p["flag"] & 4 for p in prim]
    bad = 0
    for k in range(2):
        p, m = prim[k], prim[1 - k]
        f = p["flag"]
        ok = bool(f & 1)
        if mapped[k] and mapped[1 - k]:
            same = p["rname"] == m["rname"]
            ok &= (not f & 8
                   and p["rnext"] == ("=" if same else m["rname"])
                   and p["pnext"] == m["pos"]
                   and bool(f & 0x20) == bool(m["flag"] & 0x10)
                   and p["tlen"] == (bwa_tlen(p, m) if same else 0))
        elif mapped[k]:
            ok &= bool(f & 8) and p["pnext"] == p["pos"]
        elif mapped[1 - k]:
            ok &= p["pos"] == m["pos"]
        else:
            ok &= bool(f & 8)
        bad += not ok
    if not all(mapped):
        return bad, 0, 0
    at_true = []
    for k in range(2):
        p, t = prim[k], r[k]
        lo, hi = max(p["p0"], t["start"]), min(p["p0"] + p["rlen"],
                                                t["start"] + t["span"])
        at_true.append(bool(p["flag"] & 16) == t["rev"]
                       and 2 * (hi - lo) >= t["span"])
    frag = (max(t["start"] + t["span"] for t in r)
            - min(t["start"] for t in r))
    if not all(at_true) or not band[0] <= frag <= band[1]:
        return bad, 0, 0
    want = frag - prim[0]["clip5"] - prim[1]["clip5"]
    proper = all(p["flag"] & 2 for p in prim)
    lost = not proper or any(abs(abs(p["tlen"]) - want) > 1 for p in prim)
    return bad, 1, int(lost)


def rescue_target(codes: np.ndarray, toff: int, tlen: int) -> np.ndarray:
    """Bases [toff, toff + tlen) of the genome followed by its reverse
    complement (bwa's coordinates over 2 x l_pac); N stays 4."""
    n_g = len(codes)
    if toff < n_g:
        return codes[toff:toff + tlen]
    fwd = codes[max(2 * n_g - toff - tlen, 0):2 * n_g - toff][::-1]
    return np.where(fwd == 4, 4, 3 - fwd).astype(np.uint8)


def judge_rescue(problems: list[dict], codes: np.ndarray, sc: dict,
                 device) -> tuple[int, int, int]:
    """(problems whose score is not the plain best, problems judged,
    problems skipped for an N in their stretch)."""
    qs, ts, got = [], [], []
    skipped = 0
    for pr in problems:
        t = rescue_target(codes, pr["toff"], pr["tlen"])
        if len(t) != pr["tlen"] or (t >= 4).any():
            skipped += 1
            continue
        qs.append(pr["query"])
        ts.append(t)
        got.append(pr["score"])
    best = best_local(qs, ts, sc, device)
    return int((np.asarray(got, np.int64) != best).sum()), len(qs), skipped


def judge(reads: list[dict], codes: np.ndarray, sc: dict, contig: str,
          device="cpu", control_bits: int | None = None,
          rescue: list[dict] | None = None,
          frag_band: tuple[float, float] = (0, np.inf)) -> dict:
    """The numbers of one run.  reads: one dict a sampled read, with
    "seq" (its codes as generated), "start"/"span"/"rev" (its source span),
    "mate" and "sam" (the text the program wrote for it; ignored by the
    control); the two mates of a pair follow each other.  rescue: the
    sampled pairs' rescue problems ("query", "toff", "tlen", "score").
    frag_band: the fragment lengths at which `pair_lost` judges a pair.
    With `control_bits` (the control), the reference itself takes the
    program's place: each read's score is its best local score at its true
    origin, computed with `control_bits`-bit saturating arithmetic; only
    `short_share` is then read."""
    n_g = len(codes)
    tag_bad = over = skipped = pair_bad = pair_lost = 0
    own_q, own_t, own_as = [], [], []
    tru_q, tru_t, prim_as = [], [], []
    prims: list[dict | None] = []
    for r in reads:
        seq = r["seq"]
        m = max(TRUE_MARGIN_MIN, int(TRUE_MARGIN_SHARE * r["span"]))
        lo, hi = max(r["start"] - m, 0), min(r["start"] + r["span"] + m, n_g)
        tru_q.append(seq if not r["rev"] else rc(seq))
        tru_t.append(codes[lo:hi])
        if control_bits:
            continue
        pas = 0
        prim, n_prim = None, 0
        for rec in parse_records(r["sam"]):
            if "bad" in rec or rec["name"] != r["name"]:
                tag_bad += 1
                continue
            mate = 1 if rec["flag"] & 0x80 else 0
            if mate != r.get("mate", 0):
                tag_bad += 1
                continue
            if not rec["flag"] & 0x900:
                n_prim += 1
                prim = rec
            if rec["flag"] & 4:
                continue
            try:
                ops = cigar_ops(rec["cigar"])
                ori = rc(seq) if rec["flag"] & 16 else seq
                hl = ops[0][0] if ops[0][1] == "H" else 0
                hr = ops[-1][0] if ops[-1][1] == "H" else 0
                qlen = sum(n for n, op in ops if op in "MIS=X")
                s = ENC[np.frombuffer(rec["seq"].encode(), np.uint8)]
                if (rec["rname"] != contig or qlen != len(s)
                        or hl + qlen + hr != len(seq)
                        or not np.array_equal(s, ori[hl:hl + qlen])):
                    raise ValueError("record")
                place(rec, ops)
                p0, rlen = rec["p0"], rec["rlen"]
                ref = codes[p0:p0 + rlen]
                if p0 < 0 or len(ref) < rlen:
                    raise ValueError("position")
                if (ref == 4).any():
                    skipped += 1
                    continue
                md, nm, _ = md_nm(ops, s, ref)
                if (rec["tags"].get("MD") != md
                        or int(rec["tags"].get("NM", -1)) != nm):
                    raise ValueError("tags")
                score = int(rec["tags"]["AS"])
            except (ValueError, KeyError, IndexError):
                tag_bad += 1
                if prim is rec:
                    prim = None
                continue
            w0 = max(p0 - OWN_MARGIN, 0)
            w1 = min(p0 + rlen + OWN_MARGIN, n_g)
            if (codes[w0:w1] == 4).any():
                skipped += 1
            else:
                own_q.append(ori)
                own_t.append(codes[w0:w1])
                own_as.append(score)
            if not rec["flag"] & 0x900:
                pas = score
        if n_prim != 1:
            tag_bad += 1             # bwa writes one primary line a read
            prim = None
        prim_as.append(pas)
        prims.append(prim)
    best_true = best_local(tru_q, tru_t, sc, device)
    out = {}
    if control_bits:
        prim_as = best_local(tru_q, tru_t, sc, device,
                             saturate=control_bits)
    else:
        best_own = best_local(own_q, own_t, sc, device)
        over = int((np.asarray(own_as, np.int64) > best_own).sum())
        pairs = at_home = 0
        for k in range(0, len(reads) - 1, 2):
            pr = reads[k:k + 2]
            if [x.get("mate", 0) for x in pr] != [0, 1] or \
                    pr[0]["name"] != pr[1]["name"]:
                continue
            b, home, lost = judge_pair(pr, prims[k:k + 2], frag_band)
            pair_bad += b
            pair_lost += lost
            pairs += 1
            at_home += home
        r_bad, r_n, r_skip = judge_rescue(rescue or [], codes, sc, device)
        out = {"tag_bad": tag_bad, "over_best": over,
               "pair_bad": pair_bad, "pair_lost": pair_lost,
               "rescue_bad": r_bad, "pairs": pairs,
               "pairs_at_origin": at_home,
               "rescue_judged": r_n, "rescue_skipped": r_skip}
    prim = np.asarray(prim_as, np.int64)
    short = int((prim < (1.0 - SHORTFALL) * best_true).sum())
    n = len(reads)
    out.update({"short_share": short / n if n else 1.0,
                "sampled": n, "records_skipped": skipped, "short": short,
                "worst_gap": int((best_true - prim).max()) if n else 0})
    return out
