"""Data sources and the input pipeline (port of ``gdn_tpu/data``): the
synthetic source, the KITTI and NYU loaders with velodyne GT, the
grain loader's counterpart (grain's order and cursor, decode on worker
threads), the decoded-sample and device-resident caches (sharded over
a data mesh too), the on-device wire decode and augmentation, and the
prefetch pipeline."""
