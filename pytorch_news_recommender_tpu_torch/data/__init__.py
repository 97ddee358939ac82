"""Data containers, the synthetic corpus, the serving tokenizer, batching
(numpy) and the device prefetch."""
