"""Architecture registry of the port: the reference's ids, with the
constructors of the architectures ported so far.

``ARCH_IDS`` and ``CANONICAL`` are the reference's (``repro/configs``).
The port runs all ten: the ssm family (falcon-mamba-7b), the hybrid
family (hymba-1.5b), the dense family (qwen3-32b, granite-20b,
nemotron-4-340b, llama3-405b), the MoE family with GQA
(llama4-scout-17b-a16e) and with MLA (deepseek-v2-236b), the encdec
family (whisper-small) and the VLM family (phi-3-vision-4.2b); each
constructor is a copy of the reference's.  ``paper_lp`` holds the
paper's LP workloads (``WORKLOADS``, ``build_batch``); it is not an
architecture.
"""
from importlib import import_module

from . import paper_lp  # noqa: F401

ARCH_IDS = (
    "deepseek_v2_236b",
    "llama4_scout_17b_a16e",
    "falcon_mamba_7b",
    "whisper_small",
    "qwen3_32b",
    "granite_20b",
    "nemotron_4_340b",
    "llama3_405b",
    "hymba_1_5b",
    "phi_3_vision_4_2b",
)

# canonical dashed ids from the assignment table
CANONICAL = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-small": "whisper_small",
    "qwen3-32b": "qwen3_32b",
    "granite-20b": "granite_20b",
    "nemotron-4-340b": "nemotron_4_340b",
    "llama3-405b": "llama3_405b",
    "hymba-1.5b": "hymba_1_5b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

PORTED = ("falcon_mamba_7b", "hymba_1_5b", "qwen3_32b", "granite_20b",
          "nemotron_4_340b", "llama3_405b", "llama4_scout_17b_a16e",
          "deepseek_v2_236b", "whisper_small", "phi_3_vision_4_2b")


def get_config(arch: str):
    key = CANONICAL.get(arch, arch).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}")
    return import_module(f"repro_torch.configs.{key}").config()


def all_configs():
    """{id: config} of every architecture, in ``ARCH_IDS`` order."""
    return {a: get_config(a) for a in ARCH_IDS}
