"""rescue.ms_per_kread: mate rescue's preparation, dispatch and wait
(PROF phase around ops/kswv.py), per 1,000 reads; paired traffic only."""

from portbench.readers import prof_ms_per_kread

PHASES = ("matesw",)


def read(w):
    return prof_ms_per_kread(w, PHASES)
