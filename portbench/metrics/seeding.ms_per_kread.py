"""seeding.ms_per_kread: the seeding stage's dispatch and wait (PROF
phases of ops/backend.py:collect_chunk and the per-stage path), per 1,000
reads."""

from portbench.readers import prof_ms_per_kread

PHASES = ("seeding.device", "seeding.assemble", "seeding.round1b",
          "seeding.round2", "sa_lookup")


def read(w):
    return prof_ms_per_kread(w, PHASES)
