"""The port's model zoo, all ten architectures of the reference: the ssm
family (falcon-mamba-7b) and the hybrid family (hymba-1.5b), whose
prefill runs the CUDA selective-scan kernel on the card; the dense family
(qwen3-32b, granite-20b, nemotron-4-340b, llama3-405b) and the VLM family
(phi-3-vision-4.2b), which run no custom kernel; the MoE family with GQA
(llama4-scout-17b-a16e) and with MLA (deepseek-v2-236b), whose LP capacity
router (``lp_capacity``) solves its allocation with the whole-solve
simplex kernel on the card; and the encdec family (whisper-small), whose
``EncDecLM`` runs no custom kernel."""
import torch

from ..device import resolve_device
from .config import SHAPES, ModelConfig, ShapeCell, shape_by_name  # noqa: F401
from .encdec import EncDecLM  # noqa: F401
from .transformer import LM  # noqa: F401


def build_model(cfg: ModelConfig, device=None, seed: int = 0, shd=None):
    """The model of ``cfg`` (``EncDecLM`` for the encdec family, ``LM``
    for every other) with parameters drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card unless ``device="cpu"``;
    ``None`` without a card raises).  ``shd`` (a
    ``distributed.sharding.Sharder``) keeps this rank's expert slabs of
    the same whole model."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cls = EncDecLM if cfg.family == "encdec" else LM
    return cls(cfg, device=dev, generator=gen, shd=shd)
