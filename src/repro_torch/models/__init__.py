"""The LM side's models: shared layers, the dense decoder, Mamba and the
Jamba hybrid stack, and the model API (prefill and decode steps)."""
