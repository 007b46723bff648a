"""Problem ingestion and export: MPS files <-> GeneralLPBatch
(core/forms.py)."""
from .mps import (  # noqa: F401
    FIXTURE_NAMES, MIP_FIXTURE_NAMES, fixture_path, perturbed_batch,
    perturbed_sequence, read_mps, write_mps,
)
