"""Embedding-id validation (the sharded engine is a later slice)."""
