"""The benchmark's plain reference: float32 PyTorch with TF32 off.

It imports neither JAX nor the JAX package nor the program under test, and
takes nothing the program made. From the benchmark's own inputs (the corpus,
the click log, the requests and the seeded weights) it works out again what
the program derives: the batch layout of each step, the dropout masks, the
news and user vectors, the scores, the loss, the gradients and Adam's
update.

A model family is one module, ``reference/<family>.py``, found by the
configuration's ``family`` (:func:`family`); a new family is a new file. It
gives:

* ``FEATS``: the news features its news tower reads (``title``,
  ``abst``, ``categ``, ``subcateg``);
* ``leaves(model, corpus)``: ``(name, shape, law)`` of every weight, in
  the program's state-dict names (``weights.make`` draws them);
* ``encode(p, W, model, feats, seeds=None, rate=0.0)``: ``[M, ...]`` news
  features to ``[M, D]`` vectors at precision ``p``. In training ``seeds``
  is the step's seed stream (``common.step_seeds``): a call takes one seed
  for each dropout draw the program's call makes, in the program's order
  (one for NRMS and NAML); serving passes none and draws no dropout;
* ``user(p, W, model, vecs, mask, for_top_k=False)``: ``[B, H, D]``
  clicked-news vectors to ``[B, D]`` user vectors;
* ``work(work, model, lens, news, browsed, cand)``: one slice's work for
  ``counting.Work``. What runs inside the program's fused encoder (kernel
  #1) is added as towers (``add_tower``), and only that is what the encoder
  rooflines divide; the family's own work outside it as named parts
  (``add_part``), the scores as ``other_flops`` (``counting.py``). ``lens``
  carries the corpus's news graph as ``lens["neighbors"]`` where it has one.

and, optionally, for a family whose training step is not laid out as
``layout.single`` lays it out (a news graph's neighbourhood encoded in one
buffer, say):

* ``slice_vectors(p, W, model, feats, browsed, cand, title_len, trunc,
  seeds, rate, device)``: one slice's ``(browsed [B, H, D], candidates [B,
  S, D])`` vectors from its raw impressions (numpy ``browsed``, ``cand``),
  the corpus tensors ``feats`` (``neighbors`` among them where the corpus
  has a graph), ``title_len`` by news id and the title truncation ``trunc``:
  the family's own frozen copy of the program's layout, its encode calls,
  the dropout seeds drawn from ``seeds`` in the program's order, and the
  gathers. Where a family has it, ``train.run`` calls it in place of its
  own layout; it lays out one rank's step, so such a family stops a
  reference of several ranks until it lays out theirs. Serving does not go
  through it: ``serve.py`` encodes the corpus by ``encode``.
"""

from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of model family ``name``."""
    return importlib.import_module(f"{__name__}.{name}")
