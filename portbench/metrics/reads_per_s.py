"""reads_per_s: reads whose SAM records were written in the window, over
all the window's time (host clock; whole chunks only)."""


def read(w):
    return w.reads_per_s
