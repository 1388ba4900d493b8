"""Data: the dataset readers, the input pipeline, AutoAugment and the device preprocessing."""
