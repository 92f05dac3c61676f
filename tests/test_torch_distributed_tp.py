"""The tensor-parallel encoder across processes (the mesh's 'model' axis)
against the JAX package's single-device step, and checkpoints across ranks.

dp1 x tp2 (two gloo ranks) and dp2 x tp2 (four) CTC steps start from the
JAX package's initial weights with random rel-pos biases u, v (JAX draws
zeros, which would hide a wrong head sharding of them), under adamw + Noam
with clipping at global norm 1.0, so that the norm of the full gradients
(the sharded parameters' squares summed over the model group) decides
every update. The GLU halves of pointwise_conv1, the heads of q, k, v,
pos and u, v, and the channels of the depthwise conv and its BatchNorm
(or, with conv_norm_type layer_norm, its LayerNorm, whose statistics the
ranks all-reduce) are each sharded; a wrong split changes the loss at the
first step.
Tolerances as tests/test_torch_distributed_step.py: losses relative 1e-5,
gradient norms 1e-4, parameters (gathered) within 1e-6 of JAX's outside
the entries whose gradient is at rounding level, and those within a sign
flip's reach; the ranks' parameters are equal bit for bit wherever they
hold the same slice.

The transducer at dp1 x tp2 (its encoder sharded, its prediction network
and joint replicated) against the JAX step, with the same tolerances.

The dp2 x tp2 run checkpoints after its second of four steps; four fresh
processes resume from it and take steps three and four with the same
losses bit for bit; a one-process state restores the same checkpoint to
the gathered state_dict bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conformer_nemo_tpu_torch.models.ctc_model import CTCModel
from conformer_nemo_tpu_torch.parallel.sharding import param_spec
from conformer_nemo_tpu_torch.train import checkpoint
from conformer_nemo_tpu_torch.train import lr_schedule as port_lr
from conformer_nemo_tpu_torch.train import optim as port_optim
from conformer_nemo_tpu_torch.train.trainer import init_ctc_state
from test_torch_distributed_step import (  # noqa: F401 (jax_rnnt_init: a fixture)
    LR,
    RNNT_NORMS,
    RNNT_V,
    SCHED,
    V,
    assert_params_match,
    ctc_state_dict,
    global_batch,
    jax_ctc,
    jax_rnnt_init,
    jax_steps,
    lr_sum,
    rnnt_port_cfg,
    rnnt_state_dict,
    rnnt_world,
    write_batches,
)
from torch_dist_worker import run_world

torch.set_num_threads(2)

CLIP = 1.0


def _assert_slices_equal(results: list) -> None:
    """Replicated entries equal on every rank; sharded ones on every rank
    of the same model index; the gathered state_dicts equal everywhere."""
    for r in results[1:]:
        assert r["metrics"] == results[0]["metrics"]
        for k, v in results[0]["full"].items():
            assert torch.equal(r["full"][k], v), k
    for r in results:
        peer = next(p for p in results if p["mesh"][3] == r["mesh"][3])
        for k, v in r["local"].items():
            ref = peer if param_spec(k) else results[0]
            assert torch.equal(ref["local"][k], v), k


def _run(tmp_path, enc: dict, data: int, batches: list, weights: str, **extra) -> list:
    return run_world(str(tmp_path), "steps", data * 2, family="ctc", enc=enc, vocab=V,
                     weights=weights, batches=write_batches(tmp_path, batches), sched=SCHED,
                     lr=LR, grad_clip=CLIP, data=data, model=2, **extra)


def test_dp1_tp2_ctc_steps_match_jax(tmp_path):
    state, step, pcfg, enc = jax_ctc(grad_clip=CLIP)
    weights = str(tmp_path / "w.pt")
    torch.save(ctc_state_dict(state, pcfg), weights)
    batches = [global_batch(0, True, rows=2), global_batch(1, rows=2)]
    results = _run(tmp_path, enc, 1, batches, weights)
    assert [r["mesh"] for r in results] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    # each rank holds half the heads, GLU channels and BatchNorm channels
    local = results[1]["local"]
    assert local["encoder.layers.0.self_attn.pos_bias_u"].shape == (2, 8)
    assert local["encoder.layers.0.conv.pointwise_conv1.weight"].shape == (32, 32, 1)
    assert local["encoder.layers.0.conv.batch_norm.running_var"].shape == (16,)
    _assert_slices_equal(results)
    state, noise = jax_steps(state, step, batches, results[0]["metrics"],
                             lambda st: ctc_state_dict(st, pcfg))
    assert_params_match(results[0]["full"], ctc_state_dict(state, pcfg), lr_sum(2), noise)


def test_dp1_tp2_layer_norm_ctc_steps_match_jax(tmp_path):
    """conv_norm_type layer_norm: each rank holds half the conv module's
    LayerNorm weight and bias, and the norm's mean and variance come from
    both ranks' channels (an all-reduce of the sums), as the JAX package's
    replicated LayerNorm computes them over the whole channel axis; the
    BatchNorm case's tolerances."""
    state, step, pcfg, enc = jax_ctc(grad_clip=CLIP, conv_norm_type="layer_norm")
    weights = str(tmp_path / "w.pt")
    torch.save(ctc_state_dict(state, pcfg), weights)
    batches = [global_batch(0, True, rows=2), global_batch(1, rows=2)]
    results = _run(tmp_path, enc, 1, batches, weights)
    assert [r["mesh"] for r in results] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    local = results[1]["local"]
    assert local["encoder.layers.0.conv.batch_norm.weight"].shape == (16,)
    assert local["encoder.layers.0.conv.batch_norm.bias"].shape == (16,)
    assert "encoder.layers.0.conv.batch_norm.running_var" not in local
    _assert_slices_equal(results)
    state, noise = jax_steps(state, step, batches, results[0]["metrics"],
                             lambda st: ctc_state_dict(st, pcfg))
    assert_params_match(results[0]["full"], ctc_state_dict(state, pcfg), lr_sum(2), noise)


def test_dp2_tp2_ctc_steps_match_jax_and_resume_from_a_checkpoint(tmp_path):
    state, step, pcfg, enc = jax_ctc(grad_clip=CLIP)
    weights = str(tmp_path / "w.pt")
    torch.save(ctc_state_dict(state, pcfg), weights)
    batches = [global_batch(i, padded=i == 0) for i in range(4)]
    ckpt_dir = str(tmp_path / "ckpt")
    full = _run(tmp_path, enc, 2, batches, weights, save_at=2, ckpt_dir=ckpt_dir)
    assert [r["mesh"] for r in full] == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
    _assert_slices_equal(full)
    state, noise = jax_steps(state, step, batches[:2], full[0]["metrics"],
                             lambda st: ctc_state_dict(st, pcfg))
    assert_params_match(full[0]["saved"], ctc_state_dict(state, pcfg), lr_sum(2), noise)

    resumed = _run(tmp_path, enc, 2, batches[2:], weights, resume=ckpt_dir)
    assert resumed[0]["metrics"] == full[0]["metrics"][2:]
    for k, v in full[0]["full"].items():
        assert torch.equal(resumed[0]["full"][k], v), k
    assert resumed[0]["step"] == full[0]["step"] == 4

    # the dp x tp checkpoint at world 1: the gathered tensors as they were
    model = CTCModel(pcfg)
    opt = port_optim.make_optimizer("adamw", port_lr.make_lr_schedule(SCHED, LR),
                                    weight_decay=1e-3, betas=(0.9, 0.98), grad_clip=CLIP)
    one = init_ctc_state(model, opt)
    _, meta = checkpoint.restore_train_state(ckpt_dir, one)
    assert meta["step"] == one.step == 2 and one.opt_state["count"] == 2
    for k, v in full[0]["saved"].items():
        assert torch.equal(model.state_dict()[k], v), k
    assert [tuple(m.shape) for m in one.opt_state["mu"]] == \
        [tuple(p.shape) for p in model.parameters()]


def test_dp1_tp2_transducer_steps_match_jax(tmp_path, jax_rnnt_init):
    """The transducer's encoder sharded over two ranks (one head each), its
    prediction network and joint replicated, as the JAX package's
    test_rnnt_tp_matches_dp lays them out, against the JAX step."""
    from conformer_nemo_tpu.train import rnnt_trainer as jax_rnnt_trainer

    cfg, opt, host = jax_rnnt_init
    state = jax.tree.map(jnp.array, host)
    pcfg = rnnt_port_cfg()
    weights = str(tmp_path / "w.pt")
    torch.save(rnnt_state_dict(state, pcfg), weights)
    batches = [global_batch(0, True, rows=2, v=RNNT_V), global_batch(1, rows=2, v=RNNT_V)]
    results = rnnt_world(tmp_path, weights, batches, data=1, model=2)
    _assert_slices_equal(results)
    assert results[1]["local"]["encoder.layers.0.self_attn.pos_bias_v"].shape == (1, 12)
    state, noise = jax_steps(state, jax_rnnt_trainer.make_rnnt_train_step(cfg, opt), batches,
                             results[0]["metrics"], lambda st: rnnt_state_dict(st, pcfg),
                             RNNT_NORMS)
    assert_params_match(results[0]["full"], rnnt_state_dict(state, pcfg), lr_sum(2), noise)
