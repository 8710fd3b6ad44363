"""Share of the adaptive decode's frames that the scan (A2) decoded on
the card, of all it decoded in the window (adaptive.STATS: the rest went
to native code or the golden engine on the host)."""


def read(run):
    s = run.stats
    done = s.get("adaptive.scan_frames", 0)
    total = done + s.get("adaptive.host_frames", 0) \
        + s.get("adaptive.golden_frames", 0)
    return 100.0 * done / total if total else None
