"""Fault tolerance of the port: the supervised-training loop with
checkpoint/restart, retry policy, guardrails and chaos injection."""
