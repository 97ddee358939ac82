"""News recommendation on PyTorch and CUDA: the port of
``pytorch_news_recommender_tpu`` (JAX on a TPU) to an NVIDIA H100.

The port keeps the JAX package's module names and imports nothing of it,
nor JAX. It serves (``serve.Recommender`` -> ``server.RecommenderServer``
-> ``cli serve``) and trains (``train.loop.Trainer`` -> ``cli train``, on
one card or data-parallel over ``torch.distributed``) all twelve model
families, whose towers run through the hand-written Hopper kernels in
``ops/csrc/``: the fused encoder forward, its backward and the
weight-gradient reduction. See ``ROADMAP.md`` for what is still to port.
"""
