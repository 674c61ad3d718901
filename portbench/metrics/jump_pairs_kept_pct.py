"""Share of the jump library's pairs that jump_ec keeps, over the traced
samples: 100 x the counters jump.pairs_kept / jump.pairs_in of the span
jump_ec, summed. None where no such span holds a pair."""

from portbench.spans import window_spans


def read(ctx):
    got = window_spans(ctx, {"jump_ec"})
    pairs_in = sum(s.counters.get("jump.pairs_in", 0) for s in got)
    if not pairs_in:
        return None
    kept = sum(s.counters.get("jump.pairs_kept", 0) for s in got)
    return 100.0 * kept / pairs_in
