"""Synthetic speaker data and the trial protocol."""
