"""Synthetic corpora and query logs (numpy)."""
