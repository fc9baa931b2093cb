"""Embedding caches and stage timers."""
