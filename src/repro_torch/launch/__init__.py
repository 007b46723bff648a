"""Drivers of the port: ``serve`` (prefill + greedy decode over request
waves)."""
