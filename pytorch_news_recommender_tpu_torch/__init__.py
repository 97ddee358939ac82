"""News recommendation on PyTorch and CUDA: the port of
``pytorch_news_recommender_tpu`` (JAX on a TPU) to an NVIDIA H100.

The port keeps the JAX package's module names and imports nothing of it,
nor JAX. Ported so far: the NRMS serving path (``serve.Recommender`` ->
``server.RecommenderServer`` -> ``cli serve``), whose towers run through
the hand-written Hopper kernel in ``ops/csrc/fused_encoder.cu``. See
``ROADMAP.md`` for what is still to port.
"""
