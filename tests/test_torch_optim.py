"""Port LR schedules, optimizers and WER vs the JAX package (optax).

Schedules: relative 2e-5, absolute 1e-8. JAX evaluates them in float32,
the port in Python floats: a constant such as gamma = 0.995 rounds to
float32 (4.8e-9 off), which the 1200th power turns into 6e-6 relative,
and an annealing near its end subtracts nearly equal float32 numbers.
Optimizers: three updates of the same parameters with the same gradients,
parameters within 1e-6 relative and 1e-7 absolute (fp32, the same
arithmetic in the same order). WER counts: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.decode.wer import wer_num_denom as jax_wer
from conformer_nemo_tpu.train import lr_schedule as jlr
from conformer_nemo_tpu.train import optim as jopt
from conformer_nemo_tpu_torch.decode.wer import wer_num_denom, word_error_rate
from conformer_nemo_tpu_torch.train import lr_schedule as plr
from conformer_nemo_tpu_torch.train import optim as popt

SCHEDULES = {
    "noam": {"name": "NoamAnnealing", "d_model": 256, "warmup_steps": 100, "min_lr": 1e-5,
             "max_steps": 1000},
    "noam_ratio": {"name": "NoamAnnealing", "d_model": 512, "warmup_ratio": 0.1,
                   "max_steps": 1000},
    "cosine": {"name": "CosineAnnealing", "max_steps": 1000, "warmup_steps": 50,
               "min_lr": 1e-4},
    "cosine_nowarm": {"name": "CosineAnnealing", "max_steps": 1000},
    "inv_sqrt": {"name": "InverseSquareRootAnnealing", "warmup_steps": 80, "min_lr": 1e-4},
    "warmup": {"name": "WarmupPolicy", "warmup_steps": 100, "max_steps": 1000},
    "square": {"name": "SquareAnnealing", "max_steps": 1000, "warmup_steps": 100},
    "square_root": {"name": "SquareRootAnnealing", "max_steps": 1000, "warmup_ratio": 0.05},
    "warmup_annealing": {"name": "WarmupAnnealing", "max_steps": 1000, "warmup_steps": 100,
                         "min_lr": 1e-4},
    "t5": {"name": "T5InverseSquareRootAnnealing", "constant_steps": 200, "max_steps": 1000},
    "poly": {"name": "PolynomialDecayAnnealing", "max_steps": 1000, "warmup_steps": 100,
             "power": 2.0, "min_lr": 1e-5},
    "poly_cycle": {"name": "PolynomialDecayAnnealing", "max_steps": 300, "power": 1.5,
                   "cycle": True},
    "poly_hold": {"name": "PolynomialHoldDecayAnnealing", "max_steps": 1000,
                  "warmup_steps": 50, "hold_steps": 300},
    "step_lr": {"name": "StepLR", "step_size": 150, "gamma": 0.5},
    "exponential": {"name": "ExponentialLR", "gamma": 0.995},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    cfg = SCHEDULES[name]
    port, ref = plr.make_lr_schedule(cfg, 2.0), jlr.make_lr_schedule(cfg, 2.0)
    for step in np.linspace(0, 1200, 50).astype(int):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(port(int(step)), want, rtol=2e-5, atol=1e-8,
                                   err_msg=f"{name} at {step}")


@pytest.mark.parametrize("name", ["ReduceLROnPlateau", "CyclicLR"])
def test_stateful_schedules_raise_like_jax(name):
    with pytest.raises(ValueError, match="no pure step->lr form"):
        plr.make_lr_schedule({"name": name}, 1.0)


OPTIMIZERS = {
    "adamw": dict(name="adamw", weight_decay=1e-3),
    "adam": dict(name="adam"),
    "sgd": dict(name="sgd"),
    "adamw_clip": dict(name="adamw", weight_decay=1e-2, grad_clip=3.0),
    "adamw_accumulate": dict(name="adamw", weight_decay=1e-3, every=2),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(case):
    kw = dict(OPTIMIZERS[case])
    name, every = kw.pop("name"), kw.pop("every", 1)
    sched = {"name": "NoamAnnealing", "d_model": 64, "warmup_steps": 3}
    ref = jopt.with_grad_accumulation(
        jopt.make_optimizer(name, jlr.make_lr_schedule(sched, 0.5), betas=(0.9, 0.98), **kw),
        every)
    port = popt.with_grad_accumulation(
        popt.make_optimizer(name, plr.make_lr_schedule(sched, 0.5), betas=(0.9, 0.98), **kw),
        every)
    rng = np.random.RandomState(0)
    params = [rng.randn(*s).astype(np.float32) for s in ((5, 7), (7,), (3, 2, 2))]
    p_ref = [jnp.asarray(p) for p in params]
    p_port = [torch.from_numpy(p.copy()) for p in params]
    s_ref, s_port = ref.init(p_ref), port.init(p_port)
    for step in range(3 * every):
        # gradients of growing size, so that clipping triggers on some steps only
        grads = [(step + 1) * rng.randn(*p.shape).astype(np.float32) for p in params]
        u_ref, s_ref = ref.update([jnp.asarray(g) for g in grads], s_ref, p_ref)
        p_ref = [p + u for p, u in zip(p_ref, u_ref)]
        u_port, s_port = port.update([torch.from_numpy(g) for g in grads], s_port, p_port)
        popt.apply_updates(p_port, u_port)
        for a, b in zip(p_port, p_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# a tree with leaves adafactor factors (two axes >= 128, one square, one
# 4-D) and leaves it does not
FACTORED_SHAPES = ((5, 7), (7,), (130, 140), (144, 144), (3, 3, 128, 136), (1,))


@pytest.mark.parametrize("wrap", ["plain", "clip_accumulate"])
@pytest.mark.parametrize("name", popt.NAMES)
def test_optimizer_registry_refuses_unported(name, wrap):
    """Once the seven optimizers past adamw, adam and sgd were refused; now
    every name of the registry matches optax on the JAX package's
    arguments, parameters within 1e-5 relative and 1e-6 absolute (the same
    fp32 arithmetic in other orders; pow and rsqrt may round differently).
    `plain`: eps and momentum passed as the JAX `make_optimizer` takes them,
    five updates. `clip_accumulate`: clipping by global norm at 3.0 and
    accumulation over 2 micro-batches, as the JAX package wraps them, on a
    tree that adafactor factors, for 5 inner updates whose gradients grow
    so that clipping holds on the later ones only."""
    sched = {"name": "NoamAnnealing", "d_model": 64, "warmup_steps": 3}
    if wrap == "plain":
        kw, every, shapes, calls = (dict(betas=(0.9, 0.98), eps=1e-7, momentum=0.8,
                                         weight_decay=1e-2), 1, ((5, 7), (7,), (3, 2, 2)), 5)
        grad_scale = lambda call: 1.0
    else:
        kw, every, shapes, calls = (dict(betas=(0.9, 0.98), weight_decay=1e-2, grad_clip=3.0),
                                    2, FACTORED_SHAPES, 10)
        grad_scale = lambda call: 0.002 * (call + 1)
    ref = jopt.with_grad_accumulation(
        jopt.make_optimizer(name, jlr.make_lr_schedule(sched, 0.5), **kw), every)
    port = popt.with_grad_accumulation(
        popt.make_optimizer(name, plr.make_lr_schedule(sched, 0.5), **kw), every)
    rng = np.random.RandomState(1 if wrap == "plain" else 0)
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    p_ref = [jnp.asarray(p) for p in params]
    p_port = [torch.from_numpy(p.copy()) for p in params]
    s_ref, s_port = ref.init(p_ref), port.init(p_port)
    clipped = []
    for call in range(calls):
        grads = [grad_scale(call) * rng.randn(*p.shape).astype(np.float32) for p in params]
        grads[1][call % 7] = 0.0  # rprop's and adagrad's zero branches
        clipped.append(float(popt.global_norm([torch.from_numpy(g) for g in grads])) >= 3.0)
        u_ref, s_ref = ref.update([jnp.asarray(g) for g in grads], s_ref, p_ref)
        p_ref = [p + u for p, u in zip(p_ref, u_ref)]
        u_port, s_port = port.update([torch.from_numpy(g) for g in grads], s_port, p_port)
        popt.apply_updates(p_port, u_port)
        for i, (a, b) in enumerate(zip(p_port, p_ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} call {call} leaf {shapes[i]}")
    if wrap == "clip_accumulate":
        assert any(clipped) and not all(clipped)
        assert s_port["gradient_step"] == int(s_ref.gradient_step) == 5


def test_wer_num_denom_matches_jax():
    hyps = ["the cat sat", "", "a b c d", "hello there world", "same"]
    refs = ["the cat sat on the mat", "nonempty ref", "a x c", "hello world", "same"]
    for use_cer in (False, True):
        assert wer_num_denom(hyps, refs, use_cer) == tuple(jax_wer(hyps, refs, use_cer))
    e, w = wer_num_denom(hyps, refs)
    assert word_error_rate(hyps, refs) == e / w
    with pytest.raises(ValueError):
        word_error_rate(hyps, refs[:2])
