"""How full kernel 1's lanes are: the chunks the grouped pipeline's
lanes decode over the chunk slots its launches run, each launch's lanes
times its longest lane's chunks, in % (decode.STATS: lane_chunks and
slot_chunks over the window); None where the program counts neither."""


def read(run):
    s = run.stats
    slots = s.get("decode.slot_chunks", 0)
    if not slots:
        return None
    return 100.0 * s.get("decode.lane_chunks", 0) / slots
