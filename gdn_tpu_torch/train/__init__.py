"""Training of both stages (port of ``gdn_tpu/train``)."""
