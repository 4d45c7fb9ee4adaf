"""device_idle_frac: the share of the window in which no kernel, copy or
set ran on the card (1 - busy_s / window_s, from the device trace)."""


def read(w):
    if not w.window_s:
        return None
    return 1.0 - w.busy_s / w.window_s
