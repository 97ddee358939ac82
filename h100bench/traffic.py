"""The inputs of a cell, made from the run's seed by one general generator.

Every size a traffic file or a configuration names is drawn here: the
corpus (title and abstract words, their lengths, categories), the click log
(histories and the 1 + K candidates of each impression) and the serving
requests (arrival times, the share of ``/top_k``, history and candidate
counts, news ids). Nothing here knows a cell by name: a later traffic mix is
a new file of parameters under ``traffic/``.

Steadiness from seed to seed: every length, count and arrival gap is taken
from the quantiles of its distribution, ``(i + 0.5) / n`` for ``i < n``, and
the seed only permutes them (:func:`quantile_draw`). So every seed gives the
same multiset of sizes and gaps in another order, and the same work. Which
news and words are drawn is random, from popularity laws over the corpus and
the vocabulary.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict

import numpy as np

# independent streams of one run's seed
(STREAM_CORPUS, STREAM_CLICKS, STREAM_REQUESTS, STREAM_WEIGHTS, STREAM_SAMPLE,
 STREAM_GRAPH) = range(6)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def _normal_ppf(u: np.ndarray) -> np.ndarray:
    inv = statistics.NormalDist().inv_cdf
    return np.array([inv(float(x)) for x in np.ravel(u)]).reshape(np.shape(u))


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The ``n`` quantiles ``(i + 0.5) / n`` of ``dist``, rounded to whole
    numbers where it has ``lo``/``hi`` bounds. ``dist`` is one of

    * ``{"law": "lognormal", "median": m, "sigma": s, "lo": a, "hi": b}``:
      ``m * exp(s * z)``, rounded and clipped to ``[a, b]``;
    * ``{"law": "normal", "mean": m, "std": s, "lo": a, "hi": b}``: rounded
      and clipped;
    * ``{"law": "exponential", "rate": r}``: gaps of a Poisson process, in
      seconds, not rounded."""
    u = (np.arange(n) + 0.5) / n
    law = dist["law"]
    if law == "exponential":
        return -np.log1p(-u) / float(dist["rate"])
    z = _normal_ppf(u)
    if law == "lognormal":
        x = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
    elif law == "normal":
        x = float(dist["mean"]) + float(dist["std"]) * z
    else:
        raise ValueError(f"unknown law {law!r}")
    return np.clip(np.round(x), dist["lo"], dist["hi"]).astype(np.int64)


def quantile_draw(dist: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """:func:`quantiles` of ``dist`` in an order drawn from ``rng``."""
    return rng.permutation(quantiles(dist, n))


class Popularity:
    """A Zipf law ``1 / rank^a`` over ids ``1..n``; which id holds which rank
    is a permutation drawn from the generator, so the popular ids differ from
    seed to seed while the law does not. ``a = 0`` is uniform."""

    def __init__(self, n: int, exponent: float, rng: np.random.Generator):
        self.n = int(n)
        self.rank_weight = 1.0 / np.arange(1, self.n + 1, dtype=np.float64) ** float(exponent)
        self.cdf = np.cumsum(self.rank_weight / self.rank_weight.sum())
        self.ids = (rng.permutation(self.n) + 1).astype(np.int32)

    def weights(self, power: float = 1.0) -> np.ndarray:
        """``[n + 1]``: each id's weight ``1 / rank^a`` raised to ``power``
        (0 for id 0)."""
        w = np.zeros(self.n + 1)
        w[self.ids] = self.rank_weight ** power
        return w

    def draw(self, rng: np.random.Generator, size) -> np.ndarray:
        r = np.searchsorted(self.cdf, rng.random(size), side="right")
        return self.ids[np.minimum(r, self.n - 1)]


@dataclasses.dataclass
class Corpus:
    """Per-news tables, row 0 the pad news: ``title [N+1, Lt]``, ``abst
    [N+1, La]`` (or None), ``categ`` and ``subcateg`` ``[N+1]`` (or None),
    the popularity law that clicks and requests draw news from, and the news
    graph ``neighbors [N+1, K]`` int32 (or None)."""

    title: np.ndarray
    abst: np.ndarray | None
    categ: np.ndarray | None
    subcateg: np.ndarray | None
    popularity: Popularity
    neighbors: np.ndarray | None = None

    @property
    def n_news(self) -> int:
        return self.title.shape[0]


def _words(rng, words: Popularity, lengths: np.ndarray, width: int) -> np.ndarray:
    n = len(lengths)
    ids = words.draw(rng, (n, width))
    return np.where(np.arange(width)[None, :] < lengths[:, None], ids, 0).astype(np.int32)


def make_corpus(config: Dict, seed: int) -> Corpus:
    """The corpus of ``config["corpus"]`` from ``seed``: ``n_news`` news
    plus the pad row, words from a Zipf law over the vocabulary (word 0 is
    pad), titles (and, where ``abstract_len`` is given, abstracts) of the
    stated length laws, categories and subcategories from Zipf laws, and,
    where ``graph`` is given, the news graph (module docstring)."""
    c = config["corpus"]
    rng = rng_for(seed, STREAM_CORPUS)
    n = int(c["n_news"])
    words = Popularity(int(c["vocab"]) - 1, c["word_zipf"], rng)
    t_len = quantile_draw(c["title_len"], n, rng)
    title = np.zeros((n + 1, int(c["title_width"])), np.int32)
    title[1:] = _words(rng, words, t_len, title.shape[1])
    abst = categ = subcateg = None
    if "abstract_len" in c:
        a_len = quantile_draw(c["abstract_len"], n, rng)
        abst = np.zeros((n + 1, int(c["abstract_width"])), np.int32)
        abst[1:] = _words(rng, words, a_len, abst.shape[1])
    if "n_categories" in c:
        categ = np.zeros(n + 1, np.int32)
        subcateg = np.zeros(n + 1, np.int32)
        categ[1:] = Popularity(int(c["n_categories"]) - 1, c["category_zipf"], rng).draw(rng, n)
        subcateg[1:] = Popularity(int(c["n_subcategories"]) - 1, c["category_zipf"],
                                  rng).draw(rng, n)
    pop = Popularity(n, c["news_zipf"], rng)
    corpus = Corpus(title, abst, categ, subcateg, pop)
    if "graph" in c:
        corpus.neighbors = news_graph(c["graph"], corpus, rng_for(seed, STREAM_GRAPH))
    return corpus


def news_graph(graph: Dict, corpus: Corpus, rng: np.random.Generator) -> np.ndarray:
    """The news graph of ``graph`` (module docstring) over ``corpus``:
    ``[N+1, K]`` int32, row 0 and missing neighbours 0.

    Each row is the K smallest of independent keys ``E / w^s`` (``E``
    exponential) over the news's group without itself: a weighted draw
    without replacement, in the order drawn. The keys of each group's ``2K +
    1`` heaviest members are drawn outright; the lighter members' keys, in
    rising order, are the arrivals of one Poisson process whose rate is
    their summed weight, each arrival naming a member by weight (a repeat or
    the news itself is passed over), run until no later arrival can enter
    the row. So no row looks at more of its group than it needs."""
    K = int(graph["neighbors"])
    n = corpus.n_news - 1
    kind = graph["group"]
    if kind == "none":
        group = np.zeros(n, np.int64)
    elif kind in ("categ", "subcateg"):
        if getattr(corpus, kind) is None:
            raise ValueError(f"graph group {kind!r} needs a corpus with categories")
        group = getattr(corpus, kind)[1:].astype(np.int64)
    else:
        raise ValueError(f"unknown graph group {kind!r}")
    w = corpus.popularity.weights(float(graph["sharpness"]))[1:]
    degree = quantile_draw(graph["degree"], n, rng) if "degree" in graph else np.full(n, K)
    if not 0 <= degree.min() <= degree.max() <= K:
        raise ValueError(f"graph degree law outside 0..{K}")
    # each group's members in a block, heaviest first; rows are worked out
    # at their news's place p in that order (news id order[p] + 1)
    order = np.lexsort((-w, group))
    w, degree = w[order], degree[order]
    starts, sizes = np.unique(group[order], return_index=True, return_counts=True)[1:]
    block = np.repeat(np.arange(len(starts)), sizes)
    first, size = starts[block], sizes[block]
    p = np.arange(n)
    T = 2 * K + 1
    at = np.arange(T)[None, :]
    head = np.minimum(first[:, None] + at, n - 1)
    keys = rng.exponential(size=(n, T)) / w[head]
    keys[(at >= size[:, None]) | (head == p[:, None])] = np.inf
    # the lighter members: block b's cumulative weight share, plus b, so
    # that one sorted array names a member from (block, uniform)
    light = w * (p - first >= T)
    share = np.zeros(n)
    rate = np.zeros(len(starts))
    for b, (a, m) in enumerate(zip(starts, sizes)):
        c = np.cumsum(light[a:a + m])
        rate[b] = c[-1]
        share[a:a + m] = b + (c / c[-1] if c[-1] > 0 else 0.0)
    bound = np.sort(keys, axis=1)
    t_pos = np.full((n, K), -1)
    t_keys = np.full((n, K), np.inf)
    got = np.zeros(n, np.int64)
    rows = np.flatnonzero(size > T)
    t = np.zeros(len(rows))
    while len(rows):
        t += rng.exponential(size=len(rows)) / rate[block[rows]]
        # with ``got`` arrivals in, one enters while it is below the
        # (K - got)-th smallest head key; past that, no later one can
        go = t < bound[rows, K - 1 - got[rows]]
        rows, t = rows[go], t[go]
        pick = np.searchsorted(share, block[rows] + rng.random(len(rows)), side="right")
        seen = t_pos[rows, :got[rows].max(initial=0)] == pick[:, None]
        new = (pick != rows) & ~seen.any(1)
        r = rows[new]
        t_pos[r, got[r]] = pick[new]
        t_keys[r, got[r]] = t[new]
        got[r] += 1
        left = got[rows] < K
        rows, t = rows[left], t[left]
    pos = np.concatenate([head, t_pos], 1)
    keys = np.concatenate([keys, t_keys], 1)
    take = np.argsort(keys, axis=1, kind="stable")[:, :K]
    filled = np.isfinite(np.take_along_axis(keys, take, 1))
    filled &= np.arange(K)[None, :] < degree[:, None]
    out = np.zeros((n + 1, K), np.int32)
    out[order + 1] = np.where(filled, order[np.take_along_axis(pos, take, 1)] + 1, 0)
    return out


def histories(rng, corpus: Corpus, lengths: np.ndarray, width: int) -> np.ndarray:
    """``[n, width]`` click histories of the given lengths, most recent
    last and left-padded with 0, news drawn by popularity."""
    n = len(lengths)
    ids = corpus.popularity.draw(rng, (n, width))
    return np.where(np.arange(width)[None, :] >= width - lengths[:, None], ids, 0).astype(np.int32)


@dataclasses.dataclass
class ClickLog:
    """Training impressions: ``browsed [n, H]``, ``candidates [n, 1+K]``
    (the clicked news at slot 0)."""

    browsed: np.ndarray
    candidates: np.ndarray


def make_click_log(config: Dict, traffic: Dict, corpus: Corpus, seed: int) -> ClickLog:
    """``traffic["impressions"]`` training impressions: histories of the
    traffic's length law at the configuration's history width, and 1 + K
    candidates drawn by popularity."""
    rng = rng_for(seed, STREAM_CLICKS)
    n = int(traffic["impressions"])
    H = int(config["port"]["data"]["history_len"])
    K = int(config["port"]["data"]["sample_size"])
    lengths = quantile_draw(traffic["history_len"], n, rng)
    browsed = histories(rng, corpus, lengths, H)
    cands = corpus.popularity.draw(rng, (n, 1 + K)).astype(np.int32)
    return ClickLog(browsed, cands)


@dataclasses.dataclass
class Requests:
    """An open-loop schedule: request ``i`` is due ``due[i]`` seconds after
    the window opens; ``kind[i]`` is 0 for ``/score``, 1 for ``/top_k``; its
    history is ``hist[hist_off[i]:hist_off[i+1]]`` (oldest first) and, for
    ``/score``, its candidates ``cand[cand_off[i]:cand_off[i+1]]``."""

    due: np.ndarray
    kind: np.ndarray
    hist: np.ndarray
    hist_off: np.ndarray
    cand: np.ndarray
    cand_off: np.ndarray
    k: int

    def __len__(self) -> int:
        return len(self.due)

    def history(self, i: int) -> np.ndarray:
        return self.hist[self.hist_off[i]:self.hist_off[i + 1]]

    def candidates(self, i: int) -> np.ndarray:
        return self.cand[self.cand_off[i]:self.cand_off[i + 1]]

    def arrays(self) -> Dict[str, np.ndarray]:
        return {f.name: np.asarray(getattr(self, f.name)) for f in dataclasses.fields(self)}


def make_requests(traffic: Dict, corpus: Corpus, seconds: float, seed: int,
                  rate: float | None = None) -> Requests:
    """``round(rate * seconds)`` requests at ``traffic["rate_per_s"]`` (or
    ``rate``): Poisson gaps from their quantiles, ``topk_share`` of them
    ``/top_k`` with ``k``, the others ``/score``; history and candidate
    counts from the traffic's laws; news by popularity."""
    rng = rng_for(seed, STREAM_REQUESTS)
    rate = float(traffic["rate_per_s"] if rate is None else rate)
    n = max(1, int(round(rate * seconds)))
    gaps = quantile_draw({"law": "exponential", "rate": rate}, n, rng)
    # request i is due after the first i gaps; all n gaps fill the window
    due = (np.cumsum(gaps) - gaps) * (seconds / float(gaps.sum()))
    kind = np.zeros(n, np.int8)
    kind[rng.permutation(n)[:int(round(float(traffic["topk_share"]) * n))]] = 1
    h_len = quantile_draw(traffic["history_len"], n, rng)
    c_len = np.zeros(n, np.int64)
    c_len[kind == 0] = quantile_draw(traffic["candidates"], int((kind == 0).sum()), rng)
    hist = corpus.popularity.draw(rng, int(h_len.sum())).astype(np.int32)
    cand = corpus.popularity.draw(rng, int(c_len.sum())).astype(np.int32)
    off = lambda lens: np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)  # noqa: E731
    return Requests(due, kind, hist, off(h_len), cand, off(c_len), int(traffic["k"]))
