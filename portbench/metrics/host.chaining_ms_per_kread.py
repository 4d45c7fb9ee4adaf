"""host.chaining_ms_per_kread: the host runtime's chaining (PROF phase),
per 1,000 reads."""

from portbench.readers import prof_ms_per_kread

PHASES = ("chaining",)


def read(w):
    return prof_ms_per_kread(w, PHASES)
