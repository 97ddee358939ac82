"""Host time of one ``Recommender.score_many`` call over the serving window
(the benchmark's span around the call, mean over calls)."""

LAYER = "serve.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "score_p95_ms"


def read(rec):
    d = rec.spans.get("score_many")
    if rec.kind != "serve" or not d:
        return None
    return 1e3 * sum(d) / len(d)
