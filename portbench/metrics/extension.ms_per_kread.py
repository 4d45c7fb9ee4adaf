"""extension.ms_per_kread: the extension stage's dispatch and wait (PROF
phase around ops/bsw.py), per 1,000 reads."""

from portbench.readers import prof_ms_per_kread

PHASES = ("extension.bsw",)


def read(w):
    return prof_ms_per_kread(w, PHASES)
