"""Data sources and the input pipeline (port of ``gdn_tpu/data``): the
synthetic source, the KITTI and NYU loaders with velodyne GT, the
decoded-sample and device-resident caches, the on-device wire decode
and augmentation, and the prefetch pipeline.  The grain loader is not
ported yet (ROADMAP.md Queue A item 8)."""
