"""Serving backend: sampling, tokenizer, the paged engine and the
message-driven ServingService."""
