"""Data: serving-side preprocessing."""
