"""Launchers of the port: ``serve`` (prefill + batched greedy decode)."""
