"""Data side of the port: device augmentation (``augment``)."""
