"""Share of the traced window in which no kernel, copy or memset ran on
the card, in a cell that writes."""


def read(run):
    dev = run.device
    if dev is None or dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
