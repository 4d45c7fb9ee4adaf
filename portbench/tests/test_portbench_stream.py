"""The read generator: deterministic by seed, benchdata's pair model in
its rates, and the program's chunking rule."""

import numpy as np
import pytest

from portbench import stream as st
from portbench.genome import clean_segments, make_codes

SPEC = {"seed": 3, "length": 200_000, "contig": "t",
        "families": [{"name": "a", "length": 300, "every": 3000,
                      "div": 0.02}],
        "n_runs": [["start", 10000], ["mid", 5000], ["end", 10000]]}
PE = {"read_length": 150,
      "fragment": {"dist": "normal", "mean": 420, "std": 60, "min": 160},
      "reverse_share": 0.5, "per_base": {"sub": 0.005},
      "per_read_indel": 0.05, "quality": {"const": 40}}
class R:
    def __init__(self, name, seq, qual):
        self.name, self.seq, self.qual = name, seq, qual


def codes():
    return make_codes(SPEC)


def take(s, n):
    ks1, ks2 = s.mates()
    out = []
    for _ in range(n):
        out.append(ks1.read_one())
        out.append(ks2.read_one())
    return out


def test_genome_model():
    g = codes()
    assert len(g) == 200_000 and (g[:10000] == 4).all()
    assert (g[-10000:] == 4).all() and (g[100_000:105_000] == 4).all()
    assert (g[10000:100_000] < 4).all()
    seg = clean_segments(g, 1000)
    assert seg.tolist() == [[11000, 99000], [106000, 189000]]


@pytest.mark.parametrize("seed", [2**40 + 5, 2**31 + 7, 0, -3])
def test_same_seed_same_reads_other_seed_other_reads(seed):
    g = codes()
    a = take(st.ReadStream(g, PE, seed, 10**9, R), 300)
    b = take(st.ReadStream(g, PE, seed, 10**9, R), 300)
    c = take(st.ReadStream(g, PE, seed + 1, 10**9, R), 300)
    assert [(r.name, r.seq) for r in a] == [(r.name, r.seq) for r in b]
    assert [r.seq for r in a] != [r.seq for r in c]


def test_pairs_come_from_their_origin_at_benchdata_rates():
    g = codes()
    s = st.ReadStream(g, PE, 11, 10**9, R)
    reads = take(s, 4096)
    t = s.truth()
    assert len(reads) == 8192 == len(t["seq"])
    subs = indel = 0
    for i, r in enumerate(reads):
        src = g[t["start"][i]:t["start"][i] + 150]
        if t["rev"][i]:
            src = st.rc_codes(src)
        q = np.frombuffer(r.seq.encode(), np.uint8)
        q = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), q)
        d = int((q != src).sum())
        if d > 15:
            indel += 1
        else:
            subs += d
        assert len(r.seq) == 150 and r.qual == "I" * 150
        assert r.name == str(i // 2)
    assert 0.030 < indel / 8192 < 0.075       # a shift past the indel
    assert abs(subs / (8192 * 150) - 0.005) < 0.0012
    # mates face each other: one forward, one reverse, insert apart
    rev = t["rev"]
    assert (rev[0::2] != rev[1::2]).all()
    ins = np.abs(t["start"][0::2] - t["start"][1::2]) + 150
    assert abs(ins.mean() - 420) < 5 and abs(ins.std() - 60) < 5
    assert 0.45 < rev[0::2].mean() < 0.55
    seg = clean_segments(g, st.MARGIN)
    ok = np.zeros(len(t["start"]), bool)
    for lo, hi in seg:
        ok |= (t["start"] >= lo) & (t["start"] + 150 <= hi)
    assert ok.all()


def test_chunk_ends_follow_the_program_and_stop_at_a_boundary():
    from bwamem2_tpu_torch.io.fastq import Read, read_chunk
    g = codes()
    task = 6000
    s = st.ReadStream(g, PE, 9, task, lambda n, q, ql: Read(n, None, q, ql))
    ks1, ks2 = s.mates()
    n, ends = 0, []
    for k in range(6):
        if k == 4:
            s.stop.set()
        chunk = read_chunk(ks1, ks2, task)
        if not chunk:
            break
        n += len(chunk)
        ends.append(n)
    assert ends == s.chunk_ends and len(ends) == 4
