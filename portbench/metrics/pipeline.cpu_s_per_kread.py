"""pipeline.cpu_s_per_kread: the whole process's CPU seconds
(time.process_time, every thread) over the window, per 1,000 reads."""

from portbench.window import per_kread


def read(w):
    return per_kread(w.cpu_s, w.reads)
