"""Two train steps of a tiny CTC model per subsampling mode against the
JAX package's `make_ctc_train_step` (adamw + Noam, dropout, dither and
SpecAugment off): loss and gradient norm relative 1e-4, the BatchNorm
statistics the steps write 1e-5 absolute. The configurations are
test_torch_subsampling.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conformer_nemo_tpu.train import lr_schedule as jax_lr
from conformer_nemo_tpu.train import optim as jax_optim
from conformer_nemo_tpu.train.trainer import init_ctc_state as jax_init_state
from conformer_nemo_tpu.train.trainer import make_ctc_train_step as jax_train_step
from conformer_nemo_tpu_torch.convert.jax_params import ctc_state_dict_from_jax
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel
from conformer_nemo_tpu_torch.train import lr_schedule as port_lr
from conformer_nemo_tpu_torch.train import optim as port_optim
from conformer_nemo_tpu_torch.train.trainer import init_ctc_state, make_ctc_train_step

from test_torch_subsampling import CASES, RTOL, STATS_ATOL, V, _configs


@pytest.mark.parametrize("mode,factor", [c for c in CASES if c[0] != "striding"])
def test_two_train_steps_match_jax(mode, factor):
    sched = {"name": "NoamAnnealing", "d_model": 32, "warmup_steps": 1000, "min_lr": 1e-6}
    jcfg, pcfg = _configs(mode, factor, feat_in=80)
    jopt = jax_optim.make_optimizer("adamw", jax_lr.make_lr_schedule(sched, 2.0),
                                    weight_decay=1e-3)
    jstate = jax_init_state(jcfg, jopt, jax.random.PRNGKey(0), (1, 80, 64))
    jstep = jax_train_step(jcfg, jopt)
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    model = CTCModel(pcfg)
    model.load_state_dict(ctc_state_dict_from_jax(variables, pcfg))
    popt = port_optim.make_optimizer("adamw", port_lr.make_lr_schedule(sched, 2.0),
                                     weight_decay=1e-3)
    state = init_ctc_state(model, popt)
    step = make_ctc_train_step(pcfg, popt)
    rng = np.random.RandomState(5)
    for i in range(2):
        n = 12000
        audio = (0.1 * rng.randn(2, n)).astype(np.float32)
        audio[1, 9000:] = 0.0
        batch = {"audio": audio, "audio_lens": np.array([n, 9000], np.int32),
                 "tokens": rng.randint(0, V, (2, 5)).astype(np.int32),
                 "token_lens": np.array([5, 3], np.int32)}
        jstate, m_j = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m_p = step(state, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=RTOL,
                                       err_msg=f"{key} at step {i + 1}")
    want = ctc_state_dict_from_jax({"params": jax.device_get(jstate.params),
                                    "batch_stats": jax.device_get(jstate.batch_stats)}, pcfg)
    for k, v in state.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=STATS_ATOL,
                                       err_msg=k)
