"""setup_s: seconds from the process's start to the window's start (host
clock): genome and index (first run only), kernel libraries, index upload,
the aligner, and the warm-up chunks."""


def read(w):
    return w.setup_s
