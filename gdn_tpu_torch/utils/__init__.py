"""Utilities (port of ``gdn_tpu/utils``)."""
