"""Synthetic LM data of the port: copies of the reference's NumPy
``SyntheticLM`` and ``DataPipeline`` (``data/pipeline.py``), so that the
port imports nothing of the reference.  ``data/mixture.py`` waits for
its slice (ROADMAP: the rest of the LM scaffold)."""
from .pipeline import DataPipeline, SyntheticLM  # noqa: F401
