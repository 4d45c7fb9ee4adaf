"""pipeline.sam_ms_per_kread: SAM text made by the finalize step and
written by the pipeline's writer (PROF phases), per 1,000 reads.  In
paired runs the records are made inside `pairing`, so only the write
counts here."""

from portbench.readers import prof_ms_per_kread

PHASES = ("finalize.sam", "write_output")


def read(w):
    return prof_ms_per_kread(w, PHASES)
