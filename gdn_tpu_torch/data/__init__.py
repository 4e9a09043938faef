"""Data sources (port of ``gdn_tpu/data``; only the synthetic one so far)."""
