"""News recommendation on PyTorch and CUDA: the port of
``pytorch_news_recommender_tpu`` (JAX on a TPU) to an NVIDIA H100.

The port keeps the JAX package's module names and imports nothing of it,
nor JAX. Ported so far: NRMS serving (``serve.Recommender`` ->
``server.RecommenderServer`` -> ``cli serve``) and single-device NRMS
training (``train.loop.Trainer`` -> ``cli train``), whose towers run
through the hand-written Hopper kernels in ``ops/csrc/``: the fused encoder
forward, its backward and the weight-gradient reduction. See ``ROADMAP.md``
for what is still to port.
"""
