"""Requests per ``score_many`` call over the serving window: how many
``/score`` requests the daemon's batching window (``_ScoreBatcher``) joins
into one call (the benchmark counts the requests of each call)."""

LAYER = "server.py"
UNIT = "requests"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "score_p95_ms"


def read(rec):
    calls = rec.counts.get("score_many_calls", 0)
    if rec.kind != "serve" or not calls:
        return None
    return rec.counts.get("score_many", 0) / calls
