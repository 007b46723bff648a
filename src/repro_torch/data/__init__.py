"""The port's data layer: copies of the reference's NumPy
``SyntheticLM`` and ``DataPipeline`` (``data/pipeline.py``), so that the
port imports nothing of the reference, and ``optimal_mixture``
(``data/mixture.py``), the source weights as a batch of LPs."""
from .mixture import optimal_mixture  # noqa: F401
from .pipeline import DataPipeline, SyntheticLM  # noqa: F401
