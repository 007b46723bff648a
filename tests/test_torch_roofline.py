"""The dry run's roofline (``repro_torch.analysis.roofline``) against the
reference's: the same parameter and model-FLOP arithmetic for every
config and shape; the H100's peaks in the denominators."""
import pytest

from repro.analysis import roofline as ref_roofline
from repro.configs import get_config as ref_get_config
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.analysis import roofline
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.models.config import SHAPES


def test_all_configs_are_the_reference_ones():
    from repro.configs import all_configs as ref_all_configs
    ours, theirs = all_configs(), ref_all_configs()
    assert list(ours) == list(theirs) == list(ARCH_IDS)
    for k in ours:
        assert ours[k].n_params() == theirs[k].n_params()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    total = cfg.n_params()
    assert roofline.active_params(cfg, total) == \
        ref_roofline.active_params(ref_cfg, total)
    for cell, ref_cell in zip(SHAPES, REF_SHAPES):
        assert cell.name == ref_cell.name
        assert roofline.model_flops(cfg, cell, total) == \
            ref_roofline.model_flops(ref_cfg, ref_cell, total), cell.name


def test_terms_divide_by_the_h100_peaks():
    cfg = get_config("qwen3-32b")
    rl = roofline.compute_roofline(
        cfg, SHAPES[0], per_device_flops=989e12, per_device_bytes=3.35e12,
        per_device_coll_bytes=100e9, chips=256, total_params=1e9)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == (1.0, 1.0, 2.0)
    assert rl.bottleneck == "collective"
    assert rl.hlo_flops_total == 989e12 * 256
    assert rl.useful_ratio == rl.model_flops / rl.hlo_flops_total
    # no TPU constant is left
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    assert roofline.HBM_BYTES == 80e9
