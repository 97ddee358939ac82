"""Data containers, the synthetic corpus and the serving tokenizer (numpy)."""
