"""Data pipeline: synthetic streams and partitioning (uniform / non-IID)."""
