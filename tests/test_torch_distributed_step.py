"""Data parallelism across processes: the port's two-rank train steps
against the JAX package's single-process step on the global batch.

Two gloo ranks (spawned by `torch_dist_worker.run_world`: one thread each,
a one-minute collective timeout, 240 s per spawn) take one half of each
global batch's rows, as `BucketedLoader(process_index, process_count)`
hands them out, from the same weights (the JAX package's initial ones,
crossed through the weight bridge) under adamw + Noam, dropout, dither and
SpecAugment off. The JAX package runs the same global batch in this
process on one device.

Tolerances: losses relative 1e-5 and gradient norms relative 1e-4 (fp32 on
both sides; the sums run in other orders). Parameters after two steps: the
ranks' are equal bit for bit; against JAX within 1e-6, as
tests/test_torch_train_step.py holds the one-process step, except where
Adam turns rounding into a step of +-lr: the two biases whose gradient is
zero in exact arithmetic (ZERO_GRAD), and the entries whose gradient in
some step is below 1e-4 of their tensor's largest (read from the JAX
side's Adam first moment; under 35% of every tensor, 0-5% of most). Those
are held to the most a sign flip can move them, 4 x the summed learning
rates. BatchNorm statistics within 1e-5. The synchronised BatchNorm alone:
outputs and gradients within 2e-5 relative (2e-6 absolute), as the JAX
package's own test of its data-sharded BatchNorm.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMelConfig
from conformer_nemo_tpu.models import rnnt as jax_rnnt
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models.ctc_model import CTCModelConfig as JaxCTCConfig
from conformer_nemo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from conformer_nemo_tpu.train import lr_schedule as jax_lr
from conformer_nemo_tpu.train import optim as jax_optim
from conformer_nemo_tpu.train import rnnt_trainer as jax_rnnt_trainer
from conformer_nemo_tpu.train import trainer as jax_trainer
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import (
    ctc_state_dict_from_jax,
    rnnt_state_dict_from_jax,
)
from conformer_nemo_tpu_torch.models import rnnt as port_rnnt
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.models.ctc_model import CTCModelConfig
from conformer_nemo_tpu_torch.train import lr_schedule as port_lr
from conformer_nemo_tpu_torch.train import optim as port_optim
from conformer_nemo_tpu_torch.train.rnnt_trainer import (
    RNNTTrainConfig,
    init_rnnt_state,
    make_rnnt_train_step,
)
from torch_dist_worker import run_world

torch.set_num_threads(2)

V = 11
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL = 1e-6
STATS_ATOL = 1e-5
LR = 2.0
SCHED = {"name": "NoamAnnealing", "d_model": 64, "warmup_steps": 1000, "min_lr": 1e-6}
CTC_ENC = dict(feat_in=16, n_layers=2, d_model=32, n_heads=4, ff_expansion_factor=2,
               conv_kernel_size=7, dropout=0.0, dropout_att=0.0, dropout_emb=0.0,
               use_flash_attention=True)
# gradients zero in exact arithmetic: their sign is rounding on either side
ZERO_GRAD = ("self_attn.linear_k.bias", "conv.depthwise_conv.bias")
NOISE_FLOOR = 1e-4  # of a tensor's largest gradient in a step
NOISE_SHARE = 0.35  # the most of a tensor that the noise masks may hold (linear_pos: ~0.3)
B1 = 0.9
STATS = ("running_mean", "running_var", "num_batches_tracked")


def global_batch(seed: int, padded: bool = False, rows: int = 4, v: int = V) -> dict:
    """A global batch of 0.5 s clips; with `padded`, the last row (the
    second rank's) is loader padding: zero audio, zero lengths."""
    rng = np.random.RandomState(seed)
    n = 8000
    audio = (0.1 * rng.randn(rows, n)).astype(np.float32)
    lens = np.full(rows, n, np.int32)
    lens[1::2] = [n - 1600 * (1 + i % 2) for i in range(rows // 2)]
    token_lens = np.full(rows, 5, np.int32)
    token_lens[1::2] = 3
    if padded:
        lens[-1] = token_lens[-1] = 0
    for i in range(rows):
        audio[i, lens[i]:] = 0.0
    return {"audio": audio, "audio_lens": lens,
            "tokens": rng.randint(0, v, (rows, 5)).astype(np.int32), "token_lens": token_lens}


def write_batches(tmp_path, batches: list) -> list:
    paths = []
    for i, b in enumerate(batches):
        paths.append(str(tmp_path / f"batch{i}.npz"))
        np.savez(paths[-1], **b)
    return paths


def _random_pos_biases(params, seed: int = 1):
    """The rel-pos biases u, v drawn at random (JAX initialises them to
    zero), so that a wrong head sharding of them shows."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("pos_bias_u", "pos_bias_v"):
            return jnp.asarray(0.1 * rng.randn(*leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


def jax_ctc(grad_clip=None, conv_norm_type="batch_norm"):
    """-> (a fresh copy of the initial JAX state, the jitted step, the port
    config, the encoder kwargs); the JAX step donates its state."""
    host, step, pcfg, enc = _jax_ctc(grad_clip, conv_norm_type)
    return jax.tree.map(jnp.array, host), step, pcfg, enc


@functools.lru_cache(maxsize=None)
def _jax_ctc(grad_clip, conv_norm_type):
    enc = dict(CTC_ENC)
    if conv_norm_type != "batch_norm":
        enc["conv_norm_type"] = conv_norm_type
    cfg = JaxCTCConfig(preprocessor=JaxMelConfig(features=16, dither=0.0),
                       encoder=JaxEncoderConfig(dtype=jnp.float32, **enc), num_classes=V)
    opt = jax_optim.make_optimizer("adamw", jax_lr.make_lr_schedule(SCHED, LR),
                                   weight_decay=1e-3, betas=(0.9, 0.98), grad_clip=grad_clip)
    state = jax_trainer.init_ctc_state(cfg, opt, jax.random.PRNGKey(0), (1, 16, 64))
    state = state.replace(params=_random_pos_biases(state.params))
    pcfg = CTCModelConfig(preprocessor=MelFeatureConfig(features=16, dither=0.0),
                          encoder=ConformerEncoderConfig(dtype=torch.float32, **enc),
                          num_classes=V)
    return jax.device_get(state), jax_trainer.make_ctc_train_step(cfg, opt), pcfg, enc


def ctc_state_dict(jax_state, pcfg) -> dict:
    return ctc_state_dict_from_jax({"params": jax.device_get(jax_state.params),
                                    "batch_stats": jax.device_get(jax_state.batch_stats)}, pcfg)


def lr_sum(steps: int) -> float:
    schedule = port_lr.make_lr_schedule(SCHED, LR)
    return sum(schedule(i) for i in range(steps))


def adam_mu(opt_state):
    """A host copy of the first moment of the JAX side's optax Adam state."""
    import optax

    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    adam = [x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(x)]
    return jax.device_get(adam[0].mu)


def mark_noise(noise: dict, grads: dict) -> None:
    """Mark, per parameter, the entries whose gradient of this step (port
    names) is below NOISE_FLOOR of their tensor's largest, but not zero:
    an embedding row that no token of the batch reads has no gradient on
    either side and stays held to PARAM_ATOL."""
    for k, g in grads.items():
        if not k.endswith(STATS):
            g = np.abs(np.asarray(g))
            noise[k] = noise.get(k, False) | ((g > 0) & (g < NOISE_FLOOR * g.max()))


def jax_steps(state, step, batches: list, metrics: list, to_port, norms=("grad_norm",)):
    """The JAX steps on the global batches, each held against the port's
    metrics (losses LOSS_RTOL, norms NORM_RTOL); to_port(jax state) -> a
    port state_dict. -> (the JAX state, the noise masks of its gradients,
    read from Adam's first moment before and after each step)."""
    noise: dict = {}
    for batch, got in zip(batches, metrics):
        mu = adam_mu(state.opt_state)
        state, want = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=LOSS_RTOL)
        for key in norms:
            np.testing.assert_allclose(got[key], float(want[key]), rtol=NORM_RTOL, err_msg=key)
        grads = jax.tree.map(lambda m0, m1: (m1 - B1 * m0) / (1 - B1), mu,
                             adam_mu(state.opt_state))
        mark_noise(noise, to_port(state.replace(params=grads)))
    return state, noise


def assert_params_match(got: dict, want: dict, lr_total: float, noise: dict) -> None:
    """Parameters within PARAM_ATOL outside the noise masks and ZERO_GRAD,
    within a sign flip's reach (4 x lr_total) everywhere; BatchNorm
    statistics within STATS_ATOL."""
    assert set(got) == set(want) and set(noise) == {k for k in want if not k.endswith(STATS)}
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        if k not in noise:
            np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL, err_msg=k)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=4 * lr_total, err_msg=k)
        if not k.endswith(ZERO_GRAD):
            signal = ~noise[k]
            np.testing.assert_allclose(g[signal], w[signal], rtol=0, atol=PARAM_ATOL, err_msg=k)
    shares = {k: float(m.mean()) for k, m in noise.items() if not k.endswith(ZERO_GRAD)}
    assert max(shares.values()) < NOISE_SHARE, sorted(shares.items(), key=lambda kv: -kv[1])[:6]


def assert_ranks_equal(results: list, key: str = "local") -> None:
    for r in results[1:]:
        assert r["metrics"] == results[0]["metrics"]
        for k, v in results[0][key].items():
            assert torch.equal(r[key][k], v), k


@pytest.mark.parametrize("padded", [False, True], ids=["equal_rows", "rank1_padded_row"])
def test_two_rank_ctc_steps_match_the_jax_global_batch(tmp_path, padded):
    """Rank 1 holds a loader zero row in the second case: the loss is
    sum(nll * w) / sum(w) over the global batch all the same, not the mean
    of the ranks' means."""
    state, step, pcfg, enc = jax_ctc()
    weights = str(tmp_path / "w.pt")
    torch.save(ctc_state_dict(state, pcfg), weights)
    batches = [global_batch(0, padded), global_batch(1, padded)]
    results = run_world(str(tmp_path), "steps", 2, family="ctc", enc=enc, vocab=V,
                        weights=weights, batches=write_batches(tmp_path, batches),
                        sched=SCHED, lr=LR, data=2, model=1)
    assert [r["mesh"][:3] for r in results] == [(2, 1, 0), (2, 1, 1)]
    assert_ranks_equal(results)
    state, noise = jax_steps(state, step, batches, results[0]["metrics"],
                             lambda st: ctc_state_dict(st, pcfg))
    assert_params_match(results[0]["local"], ctc_state_dict(state, pcfg), lr_sum(2), noise)


RNNT_ENC = dict(feat_in=16, n_layers=1, d_model=24, n_heads=2, ff_expansion_factor=2,
                conv_kernel_size=7, dropout=0.0, dropout_att=0.0)
RNNT_V = 7
RNNT_DEC = dict(vocab_size=RNNT_V, pred_hidden=16, dropout=0.0)
RNNT_NORMS = ("grad_norm", "encoder_grad_norm", "decoder_grad_norm", "joint_grad_norm")


def rnnt_port_cfg(joint_dropout: float = 0.0, joint_impl: str = "auto"):
    f32 = torch.float32
    return RNNTTrainConfig(
        preprocessor=MelFeatureConfig(features=16, dither=0.0),
        model=port_rnnt.RNNTModelConfig(
            encoder=ConformerEncoderConfig(dtype=f32, **RNNT_ENC),
            decoder=port_rnnt.RNNTDecoderConfig(dtype=f32, **RNNT_DEC),
            joint=port_rnnt.RNNTJointConfig(joint_hidden=16, dropout=joint_dropout, dtype=f32),
            joint_impl=joint_impl))


@pytest.fixture(scope="module")
def jax_rnnt_init():
    cfg = jax_rnnt_trainer.RNNTTrainConfig(
        preprocessor=JaxMelConfig(features=16, dither=0.0),
        model=jax_rnnt.RNNTModelConfig(
            encoder=JaxEncoderConfig(dtype=jnp.float32, **RNNT_ENC),
            decoder=jax_rnnt.RNNTDecoderConfig(dtype=jnp.float32, **RNNT_DEC),
            joint=jax_rnnt.RNNTJointConfig(joint_hidden=16, dropout=0.0, dtype=jnp.float32)))
    opt = jax_optim.make_optimizer("adamw", jax_lr.make_lr_schedule(SCHED, LR),
                                   weight_decay=1e-3, betas=(0.9, 0.98))
    state = jax_rnnt_trainer.init_rnnt_state(cfg, opt, jax.random.PRNGKey(0), (1, 16, 64))
    return cfg, opt, jax.device_get(state)


def rnnt_state_dict(jax_state, pcfg) -> dict:
    return rnnt_state_dict_from_jax({"params": jax.device_get(jax_state.params),
                                     "batch_stats": jax.device_get(jax_state.batch_stats)},
                                    pcfg.model)


def rnnt_world(tmp_path, weights, batches, joint_dropout=0.0, joint_impl="auto", data=2,
               model=1):
    return run_world(str(tmp_path), "steps", data * model, family="rnnt", enc=RNNT_ENC,
                     dec=RNNT_DEC, joint={"joint_hidden": 16, "dropout": joint_dropout},
                     joint_impl=joint_impl, weights=weights,
                     batches=write_batches(tmp_path, batches), sched=SCHED, lr=LR,
                     data=data, model=model)


def test_two_rank_transducer_steps_match_the_jax_global_batch(tmp_path, jax_rnnt_init):
    cfg, opt, host = jax_rnnt_init
    state = jax.tree.map(jnp.array, host)
    pcfg = rnnt_port_cfg()
    weights = str(tmp_path / "w.pt")
    torch.save(rnnt_state_dict(state, pcfg), weights)
    batches = [global_batch(0, True, v=RNNT_V), global_batch(1, v=RNNT_V)]
    results = rnnt_world(tmp_path, weights, batches)
    assert_ranks_equal(results)
    state, noise = jax_steps(state, jax_rnnt_trainer.make_rnnt_train_step(cfg, opt), batches,
                             results[0]["metrics"], lambda st: rnnt_state_dict(st, pcfg),
                             RNNT_NORMS)
    assert_params_match(results[0]["local"], rnnt_state_dict(state, pcfg), lr_sum(2), noise)


def test_two_rank_flash_joint_dropout_matches_one_process(tmp_path, jax_rnnt_init):
    """Joint dropout on, through the flash joint's hash: each rank passes
    its first row's offset in the global batch, so the two ranks draw the
    masks one process draws for the whole batch, and the losses and
    parameters follow the one-process port step (fp32; losses relative
    1e-5, parameters as against JAX)."""
    _, _, host = jax_rnnt_init
    pcfg = rnnt_port_cfg(joint_dropout=0.25, joint_impl="flash")
    sd = rnnt_state_dict(host, pcfg)
    weights = str(tmp_path / "w.pt")
    torch.save(sd, weights)
    batches = [global_batch(0, v=RNNT_V), global_batch(1, v=RNNT_V)]
    results = rnnt_world(tmp_path, weights, batches, joint_dropout=0.25, joint_impl="flash")
    assert_ranks_equal(results)
    model = port_rnnt.RNNTModel(pcfg.model)
    model.load_state_dict(sd)
    opt = port_optim.make_optimizer("adamw", port_lr.make_lr_schedule(SCHED, LR),
                                    weight_decay=1e-3, betas=(0.9, 0.98))
    state = init_rnnt_state(model, opt)
    step = make_rnnt_train_step(pcfg, opt)
    names = [n for n, _ in model.named_parameters()]
    losses, noise = [], {}
    for b in batches:
        mu = [m.clone() for m in state.opt_state["mu"]]
        losses.append(float(step(state, b)["loss"]))
        grads = {n: ((m1 - B1 * m0) / (1 - B1)).numpy()
                 for n, m0, m1 in zip(names, mu, state.opt_state["mu"])}
        # the LSTM's one bias is NeMo's bias_ih (bias_hh: zeros) in the state_dict
        for n in [n for n in grads if re.search(r"lstm\.bias_l\d+$", n)]:
            g = grads.pop(n)
            grads[n.replace(".bias_l", ".bias_ih_l")] = g
            grads[n.replace(".bias_l", ".bias_hh_l")] = np.zeros_like(g)
        mark_noise(noise, grads)
    np.testing.assert_allclose([m["loss"] for m in results[0]["metrics"]], losses,
                               rtol=LOSS_RTOL)
    assert_params_match(results[0]["local"], model.state_dict(), lr_sum(2), noise)


def test_batchnorm_is_synchronised_like_the_jax_data_sharded_batchnorm(tmp_path):
    """The port's BatchNorm on two ranks (each half of the rows) against the
    JAX package's nn.BatchNorm (momentum 0.9, eps 1e-5) jitted over the
    same global batch sharded on a data mesh: outputs, input gradients,
    parameter gradients (summed over the ranks) and running statistics."""
    import flax.linen as nn
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.RandomState(0)
    b, c, t = 4, 6, 5
    x = (1.5 * rng.randn(b, c, t) + 0.7).astype(np.float32)
    w = rng.randn(b, c, t).astype(np.float32)
    path = str(tmp_path / "bn.npz")
    np.savez(path, x=x, w=w)
    results = run_world(str(tmp_path), "batchnorm", 2, inputs=path)

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                                name="bn")(x)

    m = M()
    x_j = jnp.asarray(x.transpose(0, 2, 1))  # features last
    w_j = jnp.asarray(w.transpose(0, 2, 1))
    v = m.init(jax.random.PRNGKey(0), x_j)

    def loss(params, x):
        y, upd = m.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                         mutable=["batch_stats"])
        return (y * w_j).sum(), (y, upd["batch_stats"])

    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    xs = jax.device_put(x_j, NamedSharding(mesh, P("data")))
    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True))(v["params"], xs)
    tol = dict(rtol=2e-5, atol=2e-6)
    got = lambda k: torch.cat([r[k] for r in results]).numpy()
    np.testing.assert_allclose(got("y"), np.asarray(y).transpose(0, 2, 1), **tol)
    np.testing.assert_allclose(got("dx"), np.asarray(gx).transpose(0, 2, 1), **tol)
    for key, want in (("dweight", gp["bn"]["scale"]), ("dbias", gp["bn"]["bias"])):
        np.testing.assert_allclose(sum(r[key] for r in results).numpy(), np.asarray(want), **tol)
    for r in results:
        np.testing.assert_allclose(r["running_mean"].numpy(),
                                   np.asarray(stats["bn"]["mean"]), **tol)
        np.testing.assert_allclose(r["running_var"].numpy(), np.asarray(stats["bn"]["var"]),
                                   **tol)
