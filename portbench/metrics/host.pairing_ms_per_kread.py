"""host.pairing_ms_per_kread: pairing and paired SAM records (PROF
phases), per 1,000 reads; paired traffic only."""

from portbench.readers import prof_ms_per_kread

PHASES = ("pairing",)


def read(w):
    return prof_ms_per_kread(w, PHASES)
