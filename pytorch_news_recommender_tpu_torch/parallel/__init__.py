"""Multi-process runtime (``torch.distributed``)."""
