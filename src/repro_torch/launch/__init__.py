"""Drivers of the port: ``serve`` (prefill + greedy decode over request
waves) and ``train`` (AdamW steps with microbatching)."""
