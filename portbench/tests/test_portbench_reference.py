"""The plain reference at tiny sizes: the batched local alignment against
the cell-by-cell recurrence, bwa's MD / NM, and the judge on records that
are right, altered, over-scored and missing."""

import os

import numpy as np
import pytest

from conftest import ROOT
from portbench.reference import check as ck
from portbench.reference.sw import NEG, best_local

SR = {"a": 1, "b": 4, "o_del": 6, "e_del": 1, "o_ins": 6, "e_ins": 1}
LR = {"a": 1, "b": 1, "o_del": 1, "e_del": 1, "o_ins": 1, "e_ins": 1}
ODD = {"a": 2, "b": 3, "o_del": 5, "e_del": 2, "o_ins": 3, "e_ins": 1}


def best_local_scalar(q: np.ndarray, t: np.ndarray, sc: dict) -> int:
    """The same best by the textbook cell-by-cell recurrence."""
    a, b = sc["a"], sc["b"]
    oi, ei, od, ed = sc["o_ins"], sc["e_ins"], sc["o_del"], sc["e_del"]
    m, n = len(q), len(t)
    H = [[0] * (n + 1) for _ in range(m + 1)]
    E = [[NEG] * (n + 1) for _ in range(m + 1)]
    F = [[NEG] * (n + 1) for _ in range(m + 1)]
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if q[i - 1] == 4 or t[j - 1] == 4:
                s = -1
            else:
                s = a if q[i - 1] == t[j - 1] else -b
            E[i][j] = max(H[i - 1][j] - oi - ei, E[i - 1][j] - ei)
            F[i][j] = max(H[i][j - 1] - od - ed, F[i][j - 1] - ed)
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j])
    return best


@pytest.mark.parametrize("sc", [SR, LR, ODD])
def test_batched_equals_scalar(sc):
    rng = np.random.default_rng(7)
    qs, ts = [], []
    for _ in range(30):
        t = rng.integers(0, 4, int(rng.integers(5, 50))).astype(np.uint8)
        if rng.random() < 0.3:
            t[int(rng.integers(0, len(t)))] = 4
        q = rng.integers(0, 4, int(rng.integers(3, 35))).astype(np.uint8)
        if rng.random() < 0.6:
            s = int(rng.integers(0, len(t) - 4))
            q = t[s:s + int(rng.integers(4, 30))].copy()
            q[q == 4] = 1
            k = int(rng.integers(1, len(q))) if len(q) > 1 else 0
            q = np.concatenate([q[:k], [2, 0], q[k + 1:]]).astype(np.uint8)
        qs.append(q)
        ts.append(t)
    got = best_local(qs, ts, sc)
    assert got.tolist() == [best_local_scalar(q, t, sc)
                            for q, t in zip(qs, ts)]


def test_saturation_caps_the_control():
    q = np.random.default_rng(1).integers(0, 4, 150).astype(np.uint8)
    assert best_local([q], [q], SR).tolist() == [150]
    assert best_local([q], [q], SR, saturate=8).tolist() == [127]
    assert best_local([q], [q], SR, saturate=16).tolist() == [150]


def enc(s):
    return ck.ENC[np.frombuffer(s.encode(), np.uint8)]


def test_md_nm_as_bwa_writes_them():
    ref = enc("ACGTACGTAAACCCGGGTTT")
    # 4 matches, a mismatch, 3 matches, 2 inserted, 2 matches, 3 deleted, 4
    q = enc("ACGTTCGT" + "GG" + "AA" + "CGGG")
    ops = ck.cigar_ops("8M2I2M3D4M")
    md, nm, rlen = ck.md_nm(ops, q, ref)
    assert (md, nm, rlen) == ("4A5^ACC4", 1 + 2 + 3, 17)
    md, nm, _ = ck.md_nm(ck.cigar_ops("3S5M"), enc("TTTACGTA"), ref)
    assert (md, nm) == ("5", 0)


def make_genome(n=3000, seed=2):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def record(name, flag, pos, cigar, seq, AS, NM, MD, mate=None):
    fl = flag | ({0: 0x41, 1: 0x81}[mate] if mate is not None else 0)
    return (f"{name}\t{fl}\tchr\t{pos}\t60\t{cigar}\t*\t0\t0\t{seq}\t*\t"
            f"NM:i:{NM}\tMD:Z:{MD}\tAS:i:{AS}\n")


def one_read(g, start, rev, L=100):
    src = g[start:start + L].copy()
    src[40] = (src[40] + 1) % 4          # one substitution
    seq = ck.rc(src) if rev else src
    fwd = src
    text = "".join("ACGT"[c] for c in fwd)
    md = f"40{'ACGT'[g[start + 40]]}59"
    return seq, text, md


def test_judge_sound_altered_overscored_missing():
    g = make_genome()
    reads = []
    for i, (start, rev) in enumerate([(100, False), (900, True),
                                      (1500, False), (2200, True)]):
        seq, text, md = one_read(g, start, rev)
        sam = record(str(i), 16 if rev else 0, start + 1, "100M", text,
                     95, 1, md)
        reads.append({"name": str(i), "seq": seq, "start": start,
                      "span": 100, "rev": rev, "sam": sam})
    good = ck.judge(reads, g, SR, "chr")
    assert (good["tag_bad"], good["over_best"], good["short"]) == (0, 0, 0)
    ctrl = ck.judge(reads, g, SR, "chr", control_bits=8)
    assert ctrl["short"] == 0            # 95 fits in 8 bits
    bad = [dict(r) for r in reads]
    bad[0]["sam"] = bad[0]["sam"].replace("\t101\t", "\t102\t")
    bad[1]["sam"] = bad[1]["sam"].replace("AS:i:95", "AS:i:99")
    bad[2]["sam"] = f"2\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n"
    bad[3]["sam"] = bad[3]["sam"].replace("MD:Z:40", "MD:Z:41")
    out = ck.judge(bad, g, SR, "chr")
    assert out["tag_bad"] == 2 and out["over_best"] == 1
    assert out["short"] == 3             # unmapped, and two rejected records
    assert out["short_share"] == 0.75


def test_the_8bit_control_fails_full_length_short_reads():
    g = make_genome(20000, 5)
    rng = np.random.default_rng(3)
    reads = []
    for i in range(40):
        start = int(rng.integers(100, 19000))
        src = g[start:start + 150].copy()
        reads.append({"name": str(i), "seq": src, "start": start,
                      "span": 150, "rev": False, "sam": ""})
    out = ck.judge(reads, g, SR, "chr", control_bits=8)
    assert out["short_share"] == 1.0     # 127 < 0.9 * 150


GOLDEN = os.path.join(ROOT, "tests", "fixtures")


@pytest.mark.parametrize("name", ["golden_pe.sam", "golden_pe_I400_50.sam",
                                  "golden_pe_P.sam", "golden_pe_S.sam",
                                  "golden_mixed_p.sam"])
def test_mate_fields_as_bwa_mem2_writes_them(name):
    """The mate-field rules of `pair_bad` hold on every pair of bwa-mem2
    v2.2.1's own paired output (the repo's golden files): both mapped, on
    two contigs, one mate unmapped."""
    with open(os.path.join(GOLDEN, name)) as f:
        recs = ck.parse_records("".join(x for x in f if x[0] != "@"))
    prim = {}
    for r in recs:
        if r["flag"] & 0x900 or not r["flag"] & 1:
            continue
        if not r["flag"] & 4:
            ck.place(r, ck.cigar_ops(r["cigar"]))
        prim[r["name"], bool(r["flag"] & 0x80)] = r
    far = [{"start": -10**9, "span": 150, "rev": False}] * 2
    pairs = [[prim[n, False], prim[n, True]] for n, m in prim if not m]
    assert len(pairs) >= 60
    assert sum(ck.judge_pair(far, p)[0] for p in pairs) == 0


def pair_at(g, start, frag, L=150):
    """A forward fragment's two mates, their truth and bwa's records."""
    s1, s2 = start, start + frag - L
    m1, m2 = g[s1:s1 + L].copy(), ck.rc(g[s2:s2 + L])
    text = ["".join("ACGT"[c] for c in x) for x in (m1, ck.rc(m2))]
    sam = [f"p\t99\tchr\t{s1 + 1}\t60\t{L}M\t=\t{s2 + 1}\t{frag}\t{text[0]}"
           f"\t*\tNM:i:0\tMD:Z:{L}\tAS:i:{L}\n",
           f"p\t147\tchr\t{s2 + 1}\t60\t{L}M\t=\t{s1 + 1}\t{-frag}\t"
           f"{text[1]}\t*\tNM:i:0\tMD:Z:{L}\tAS:i:{L}\n"]
    return [{"name": "p", "mate": k, "seq": (m1, m2)[k],
             "start": (s1, s2)[k], "span": L, "rev": bool(k),
             "sam": sam[k]} for k in (0, 1)]


@pytest.mark.parametrize("edit,numbers", [
    (None, (0, 0)),
    (lambda t: t.replace("p\t99\t", "p\t97\t"), (0, 1)),      # 0x2 lost
    (lambda t: t.replace("\t=\t1001\t", "\t=\t1002\t"), (1, 0)),  # PNEXT
    (lambda t: t.replace("\t420\t", "\t425\t"), (1, 1)),      # TLEN
    (lambda t: t.replace("p\t147\t", "p\t179\t"), (1, 0)),    # 0x20 on 2
])
def test_pair_judge(edit, numbers):
    g = make_genome(4000, 9)
    reads = pair_at(g, 1000, 420)
    if edit:
        for r in reads:
            r["sam"] = edit(r["sam"])
    out = ck.judge(reads, g, SR, "chr")
    assert out["pairs"] == 1 and out["tag_bad"] == 0
    assert (out["pair_bad"], out["pair_lost"]) == numbers
    assert out["pairs_at_origin"] == 1


def test_rescue_judge_both_strands():
    g = make_genome(5000, 11)
    n = len(g)
    mate = g[3000:3150].copy()
    mate[70] = (mate[70] + 1) % 4
    probs = [{"query": mate, "toff": 2800, "tlen": 600, "score": 145},
             # the reverse strand: [2n - 3400, 2n - 2800) is rc(g[2800:3400])
             {"query": ck.rc(mate), "toff": 2 * n - 3400, "tlen": 600,
              "score": 145},
             {"query": mate, "toff": 100, "tlen": 600, "score": 0}]
    best = best_local([p["query"] for p in probs],
                      [ck.rescue_target(g, p["toff"], p["tlen"])
                       for p in probs], SR)
    assert best[:2].tolist() == [145, 145] and 0 < best[2] < 40
    assert ck.judge_rescue(probs, g, SR, "cpu") == (1, 3, 0)
    probs[2]["score"] = int(best[2])
    assert ck.judge_rescue(probs, g, SR, "cpu") == (0, 3, 0)


def test_pair_lost_judges_fragments_in_the_band_only():
    """A pair outside the band may rightly lack 0x2 (bwa's per-chunk insert
    bounds); inside it, it may not."""
    g = make_genome(4000, 9)
    reads = pair_at(g, 1000, 420)
    for r in reads:
        r["sam"] = r["sam"].replace("p\t99\t", "p\t97\t")
    out = ck.judge(reads, g, SR, "chr", frag_band=(300, 400))
    assert (out["pair_lost"], out["pairs_at_origin"]) == (0, 0)
    out = ck.judge(reads, g, SR, "chr", frag_band=(300, 540))
    assert (out["pair_lost"], out["pairs_at_origin"]) == (1, 1)
