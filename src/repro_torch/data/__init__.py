"""Data: synthetic classification pools for the selection experiments
(tasks.py) and the LM training pipeline (pipeline.py); numpy only."""
