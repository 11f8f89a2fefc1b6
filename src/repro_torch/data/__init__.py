"""Data for the selection experiments (tasks.py: synthetic classification
pools, numpy only)."""
