"""Tokenizers the engine decodes with (the byte tokenizer for now)."""
