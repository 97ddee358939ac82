"""Host time of one training batch's build on the feed's thread: the mean
length of the program's ``newsrec.feed.build`` spans (``next`` of the host
batch iterator inside ``device_prefetch``'s worker: the loader's shuffle
slice, dedup and length split) that start inside the traced stretch, read
from the program's span buffer (``utils/tracing.py``) in this process.

The buffer and the trace share the profiler's clock (``time.time_ns()``)
but the record holds no offset between the trace's microseconds and it, so
the stretch is found in the buffer by the stepping thread's
``newsrec.feed.wait`` spans: the trace's first wait in the window is the
buffer's wait of the same rank from the end, which places the window on the
buffer's clock. Builds of an earlier profile (``RankRun.traced``'s discarded
warm-up) fall before it. Reads nothing where the steps ran in other
processes, or where the program has no such spans."""

LAYER = "data/loader.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_impressions_per_s"
SPAN = "newsrec.feed.build"
WAIT = "newsrec.feed.wait"


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    try:
        from pytorch_news_recommender_tpu_torch.utils import tracing
    except ImportError:
        return None
    lo, hi = rec.trace.window
    waits = sorted(s for rs in rec.trace.host.values() for s, _, n in rs
                   if n == WAIT and lo <= s <= hi)
    spans = tracing.snapshot()
    buffered = sorted(s.start_ns for s in spans if s.name == WAIT)
    if not waits or len(buffered) < len(waits):
        return None
    # the buffer's stamp of a span precedes its range's by microseconds
    offset_ns = buffered[-len(waits)] - 1e3 * waits[0]
    lo_ns, hi_ns = 1e3 * lo + offset_ns, 1e3 * hi + offset_ns
    d = [s.end_ns - s.start_ns for s in spans if s.name == SPAN and lo_ns <= s.start_ns <= hi_ns]
    if not d:
        return None
    return 1e-6 * sum(d) / len(d)
