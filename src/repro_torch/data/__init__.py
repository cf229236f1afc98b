"""Synthetic speaker data and the trial protocol; the synthetic LM token
pipeline."""
