"""The port's falcon-mamba training path (repro_torch.models loss,
repro_torch.optim, repro_torch.distributed, repro_torch.data,
repro_torch.launch.train) against the reference.

The reference's reduced falcon-mamba config (float32) is initialized from
``PRNGKey(0)`` and carried into the port with ``interop.lm_from_reference``;
gradients and parameters come back with ``interop.lm_to_reference``.  Data
comes from the two packages' ``DataPipeline`` (equal bit for bit) or from
NumPy seeds.  The bars are the reference's own between its two scan paths
(tests/test_ssm_kernel.py): loss within 1e-5, gradients within 1e-4.
"""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataPipeline as RefPipeline
from repro.distributed.steps import global_norm as ref_global_norm
from repro.distributed.steps import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.models import mamba as ref_mamba
from repro.models.layers import cross_entropy as ref_cross_entropy
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.core.fp import fma
from repro_torch.data import DataPipeline
from repro_torch.distributed import global_norm, make_train_step
from repro_torch.interop import lm_from_reference, lm_to_reference
from repro_torch.kernels import ssm_scan, ssm_scan_bwd
from repro_torch.models import mamba
from repro_torch.models.layers import cross_entropy
from repro_torch.models.mamba import MambaCache, mamba_apply
from repro_torch.optim import adamw, get_optimizer

ARCH = "falcon-mamba-7b"
ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _cfgs(**kw):
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@functools.cache
def _reference(impl="kernel", remat="none"):
    """(reference cfg, model, params, params as NumPy, port cfg)."""
    ref_cfg, port_cfg = _cfgs(ssm_impl=impl, remat=remat)
    model = ref_build_model(ref_cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    return ref_cfg, model, params, jax.tree.map(np.asarray, params), port_cfg


def _port(impl="kernel", remat="none"):
    _, _, _, params_np, port_cfg = _reference(impl, remat)
    return port_cfg, lm_from_reference(port_cfg, params_np, "cpu")


def _max_diff(got_tree, want_tree):
    got, want = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(got, want))


def _batch(tokens):
    return {"tokens": tokens, "labels": tokens}


# ---- layers ---------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_the_reference(masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 5, 17)) * 4).astype(np.float32)
    labels = rng.integers(0, 17, (3, 5))
    mask = rng.random((3, 5)) < 0.6 if masked else None
    want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---- loss and gradients ---------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("impl", ["assoc", "kernel"])
def test_loss_and_gradients_match_the_reference(impl, remat):
    ref_cfg, model, params, _, _ = _reference(impl, remat)
    port_cfg, lm = _port(impl, remat)
    toks = np.random.default_rng(0).integers(0, ref_cfg.vocab, (2, 32))
    loss_r, grads_r = jax.value_and_grad(model.loss_fn)(
        params, _batch(jnp.asarray(toks, jnp.int32)))
    loss = lm.loss_fn(_batch(torch.from_numpy(toks)))
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    assert abs(float(loss.detach()) - float(loss_r)) < LOSS_TOL
    assert _max_diff(lm_to_reference(lm, grads), grads_r) < GRAD_TOL


def test_masked_labels_count_neither_in_the_loss_nor_in_the_mean():
    ref_cfg, model, params, _, _ = _reference()
    _, lm = _port()
    toks = np.random.default_rng(2).integers(0, ref_cfg.vocab, (2, 32))
    labels = toks.copy()
    labels[0, :20] = -1
    want = model.loss_fn(params, {"tokens": jnp.asarray(toks, jnp.int32),
                                  "labels": jnp.asarray(labels, jnp.int32)})
    with torch.no_grad():
        got = lm.loss_fn({"tokens": torch.from_numpy(toks),
                          "labels": torch.from_numpy(labels)})
        full = lm.loss_fn(_batch(torch.from_numpy(toks)))
    assert abs(float(got) - float(want)) < LOSS_TOL
    assert abs(float(got) - float(full)) > 1e-3


@pytest.mark.parametrize("impl", ["assoc", "kernel"])
def test_mamba_apply_gradients_across_chunks_match_the_reference(impl):
    """Three 16-token chunks, so the carry's cotangent (g_hT != 0) runs
    through the scan's backward into the earlier chunks."""
    ref_cfg, _, params, _, port_cfg = _reference(impl)
    _, lm = _port(impl)
    p_ref = jax.tree.map(lambda a: a[0], params["layers"]["ssm"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 48, 64)).astype(np.float32)
    w = rng.normal(size=(2, 48, 64)).astype(np.float32)

    def ref_loss(p, x):
        y, _ = ref_mamba.mamba_apply(p, x, ref_cfg, mode="train", chunk=16)
        return (y * w).sum()

    grads_r = jax.grad(ref_loss, argnums=(0, 1))(p_ref, jnp.asarray(x))
    p = lm.blocks[0].ssm
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = mamba_apply(p, xt, port_cfg, mode="train", chunk=16)
    names = list(p.keys())
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                [p[k] for k in names] + [xt])
    got = {k: g.numpy() for k, g in zip(names, grads)}
    assert _max_diff((got, grads[-1].numpy()), grads_r) < GRAD_TOL


# ---- the train step and the optimizer --------------------------------------

def _lr_schedule(lr, steps, warmup=100):
    return [lr * min(1.0, (s + 1) / warmup) for s in range(steps)]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_the_reference(microbatches):
    """Losses within 1e-5 and grad norms within 1e-5 relative at every
    step.  Parameters after three AdamW steps: Adam divides each gradient
    entry by its own running size, so an entry near zero whose sign the
    two frameworks' float32 sums decide differently moves by up to
    ``lr_t * max|m_hat / sqrt(v_hat)|`` either way.  For b1 = 0.9, b2 =
    0.95 and t <= 3 that maximum is sqrt(sum_i w_i^2 / u_i) <= 1.001 (w,
    u the bias-corrected weights of the two moments), so each entry may
    differ by up to 2.002 * lr_t a step, plus float32 rounding of
    parameters of size about 1; every other entry moves by the same step
    to a few ulps."""
    ref_cfg, model, params, _, _ = _reference()
    port_cfg, lm = _port()
    lr, steps = 3e-3, 3
    ref_opt = ref_adamw(lr=lr)
    ref_step = jax.jit(ref_make_train_step(model, ref_opt,
                                           microbatches=microbatches))
    opt = adamw(lr=lr)
    opt_state = opt.init(list(lm.parameters()))
    step_fn = make_train_step(lm, opt, microbatches=microbatches)
    ref_state = ref_opt.init(params)
    data = DataPipeline(vocab=ref_cfg.vocab, batch=4, seq=32, seed=0)
    for s in range(steps):
        host = data.batch_at(s)
        params, ref_state, m_r = ref_step(
            params, ref_state, jax.tree.map(jnp.asarray, host))
        m = step_fn(opt_state, {k: torch.from_numpy(v).long()
                                for k, v in host.items()})
        assert abs(float(m["loss"]) - float(m_r["loss"])) < LOSS_TOL, s
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(m_r["grad_norm"]), rtol=1e-5)
    assert opt_state["step"] == steps
    got = jax.tree.leaves(lm_to_reference(lm))
    want = jax.tree.leaves(jax.tree.map(np.asarray, params))
    flip = 2.002 * sum(_lr_schedule(lr, steps)) + 1e-6
    diffs = np.concatenate([np.abs(g - w).ravel()
                            for g, w in zip(got, want)])
    assert diffs.max() <= flip
    # the bound is for the few entries near zero; the rest agree closely
    assert np.quantile(diffs, 0.9999) < 1e-6
    # and the steps did move the parameters, by about sum(lr_t)
    start = jax.tree.leaves(_reference()[3])
    moved = max(float(np.abs(g - w).max()) for g, w in zip(got, start))
    assert moved > 0.9 * sum(_lr_schedule(lr, steps))


def test_optimizer_update_is_the_reference_one():
    """One AdamW update on the same float32 and bf16 parameters and
    gradients: float32 moments, parameters back in their dtype, the
    warmup and the decay inside the step."""
    rng = np.random.default_rng(4)
    p32 = rng.normal(size=(6, 5)).astype(np.float32)
    g32 = (rng.normal(size=(6, 5)) * 0.1).astype(np.float32)
    ref = ref_adamw(lr=1e-2, warmup=3)
    opt = get_optimizer("adamw", lr=1e-2, warmup=3)
    for dtype in ("float32", "bfloat16"):
        params = {"w": jnp.asarray(p32, dtype)}
        state = ref.init(params)
        tp = [torch.from_numpy(p32).to(getattr(torch, dtype))]
        ts = opt.init(tp)
        for _ in range(4):
            params, state = ref.update({"w": jnp.asarray(g32, dtype)}, state,
                                       params)
            opt.update([torch.from_numpy(g32).to(getattr(torch, dtype))],
                       ts, tp)
        assert tp[0].dtype == getattr(torch, dtype)
        assert ts["m"][0].dtype == ts["v"][0].dtype == torch.float32
        np.testing.assert_allclose(tp[0].float().numpy(),
                                   np.asarray(params["w"], np.float32),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["v"][0].numpy(),
                                   np.asarray(state["v"]["w"]), rtol=1e-6)
    # Adafactor is ported too (tests/test_torch_adafactor.py)
    assert get_optimizer("adafactor").update is not None
    with pytest.raises(KeyError):
        get_optimizer("sgd")


def test_global_norm_is_the_reference_one():
    rng = np.random.default_rng(5)
    leaves = [rng.normal(size=s).astype(np.float32)
              for s in ((3, 4), (7,), (2, 2, 2))]
    want = ref_global_norm([jnp.asarray(a) for a in leaves])
    got = global_norm([torch.from_numpy(a) for a in leaves])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_step_rejects_a_batch_that_does_not_split():
    _, lm = _port()
    opt = adamw()
    step = make_train_step(lm, opt, microbatches=3)
    toks = torch.zeros((4, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="3 microbatches"):
        step(opt.init(list(lm.parameters())), _batch(toks))


# ---- data and CLI ----------------------------------------------------------

@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 2)])
def test_batch_at_is_the_reference_batch(host_id, num_hosts):
    kw = dict(vocab=300, batch=4, seq=24, seed=7, host_id=host_id,
              num_hosts=num_hosts)
    ref, port = RefPipeline(**kw), DataPipeline(**kw)
    for step in (0, 3, 11):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="split over 3 hosts"):
        DataPipeline(vocab=300, batch=4, seq=24, num_hosts=3)


def test_train_cli_runs_on_the_cpu_and_prints_finite_losses(tmp_path):
    curve = tmp_path / "curve.csv"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32", "--log-every", "1", "--curve-out", str(curve)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        check=True, capture_output=True, text=True, timeout=300).stdout
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step=")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "[train] final loss" in out
    rows = curve.read_text().splitlines()
    assert rows[0] == "step,loss" and len(rows) == 4


def test_train_counts_no_kernel_launch_on_the_cpu():
    from repro_torch.launch.train import train
    port_cfg, lm = _port()
    before = (ssm_scan.launches, ssm_scan_bwd.launches)
    res = train(port_cfg, lm, batch=2, seq=16, steps=2, microbatches=2,
                device="cpu")
    assert (ssm_scan.launches, ssm_scan_bwd.launches) == before
    assert len(res["losses"]) == 2 and np.isfinite(res["grad_norms"]).all()
    assert res["tokens_per_s"][0] == 2 * 16 / res["step_s"][0]
    with pytest.raises(ValueError, match="the model is on cpu"):
        train(port_cfg, lm, batch=2, seq=16, steps=1, device="meta")


# ---- decode rounds its state update once ------------------------------------

def _decode_inputs(seed=8):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    h = (rng.normal(size=(2, 128, 8)) * 0.5).astype(np.float32)
    conv = rng.normal(size=(2, 3, 128)).astype(np.float32)
    return x1, h, conv


def test_decode_state_is_one_fused_multiply_add_of_its_coefficients(
        monkeypatch):
    port_cfg, lm = _port()
    x1, h, conv = _decode_inputs()
    seen = []
    real = mamba._ssm_coeffs

    def keep(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(mamba, "_ssm_coeffs", keep)
    cache = MambaCache(torch.from_numpy(h), torch.from_numpy(conv))
    with torch.no_grad():
        _, new = mamba_apply(lm.blocks[0].ssm, torch.from_numpy(x1),
                             port_cfg, mode="decode", cache=cache)
    (dA, dBx, _), = seen
    assert torch.equal(new.h, fma(cache.h, dA[:, 0], dBx[:, 0]))
    assert not torch.equal(new.h, cache.h * dA[:, 0] + dBx[:, 0])


def test_the_reference_jitted_decode_state_is_one_fused_multiply_add():
    """The reference's jitted decode computes ``h * dA + dBx`` as one
    fused multiply-add: on its own coefficients (its jitted
    ``_ssm_coeffs`` of the same conv output), ``fma`` gives its state bit
    for bit, and the twice-rounded form does not.  With the test above,
    the port's decode rounds as the reference's does; the two packages'
    coefficients themselves differ in the last bit (torch's and XLA's
    float32 ``exp`` and ``softplus``), which the decode tests of
    tests/test_torch_mamba.py hold to atol 1e-5."""
    ref_cfg, _, params, _, _ = _reference()
    x1, h, conv = _decode_inputs()
    p = jax.tree.map(lambda a: a[0], params["layers"]["ssm"])
    cache = ref_mamba.MambaCache(jnp.asarray(h), jnp.asarray(conv))
    _, new = jax.jit(functools.partial(ref_mamba.mamba_apply, cfg=ref_cfg,
                                       mode="decode"))(p, jnp.asarray(x1),
                                                       cache=cache)

    @jax.jit
    def coeffs(p, x):     # the reference decode's lines up to the update
        xr = jnp.split(x @ p["w_in"], 2, axis=-1)[0]
        win = jnp.concatenate([cache.conv, xr], axis=1)
        xc = jnp.einsum("bcd,cd->bd", win, p["conv_w"]) + p["conv_b"]
        return ref_mamba._ssm_coeffs(p, jax.nn.silu(xc)[:, None], ref_cfg)

    dA, dBx, _ = (torch.from_numpy(np.array(a))
                  for a in coeffs(p, jnp.asarray(x1)))
    want = np.asarray(new.h)
    h_t = torch.from_numpy(h)
    np.testing.assert_array_equal(fma(h_t, dA[:, 0], dBx[:, 0]).numpy(),
                                  want)
    assert not np.array_equal((h_t * dA[:, 0] + dBx[:, 0]).numpy(), want)
