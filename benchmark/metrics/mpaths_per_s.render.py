"""Millions of paths a second over the run's window: the frame's real
pixels (padding lanes not counted) times the frames completed, over the
window's seconds. The host's issue of the frame sets this rate; it
spreads too widely between runs to be held to a bound."""


def read(run):
    return run.end_to_end.get("mpaths_per_s")
