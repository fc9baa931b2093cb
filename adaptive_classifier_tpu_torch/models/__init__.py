"""Encoder, tokenizer and classification head."""
