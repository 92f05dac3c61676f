"""Checkpoint files across the packages through `fit`: a port `fit` of two
steps with an experiment manager, `scripts/convert_checkpoint.py` to the
JAX format, the JAX package's fit resuming it to step 3 (the file's
weights the port run's, bit for bit); and the JAX package's fit of two
steps resumed by the port's fit through `trainer.resume_from_checkpoint`.
"""

import os

import jax.numpy as jnp
import torch

from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
from conformer_nemo_tpu.train import checkpoint as jax_ckpt
from conformer_nemo_tpu.train.exp_manager import ExperimentManager as JaxExpManager
from conformer_nemo_tpu.train.exp_manager import ExpManagerConfig as JaxExpManagerConfig
from conformer_nemo_tpu_torch.api import ConformerCTC
from conformer_nemo_tpu_torch.convert.jax_params import ctc_state_dict_from_jax
from conformer_nemo_tpu_torch.scripts import convert_checkpoint
from conformer_nemo_tpu_torch.train.exp_manager import ExpManagerConfig, ExperimentManager

from test_torch_fit import CONFIG, TINY, manifest  # noqa: F401 (a fixture)
from test_torch_jax_checkpoint import _host

torch.set_num_threads(2)


def test_checkpoint_files_cross_both_ways(manifest, tmp_path):  # noqa: F811
    over = {**TINY, "model.spec_augment.freq_masks": 0, "model.spec_augment.time_masks": 0,
            "model.preprocessor.dither": 0.0, "model.encoder.dropout": 0.0,
            "model.encoder.dropout_att": 0.0, "model.encoder.dropout_emb": 0.0,
            "model.encoder.remat": False}
    # the port's run -> the JAX format -> the JAX package resumes it
    pm = ConformerCTC.from_config_file(CONFIG, overrides=over, device="cpu", dtype=torch.float32)
    em = ExperimentManager(ExpManagerConfig(exp_dir=str(tmp_path / "port"),
                                            create_tensorboard_logger=False))
    assert pm.fit(manifest, manifest, max_steps=2, exp_manager=em)["steps"] == 2
    em.wait_for_saves()
    out_dir = str(tmp_path / "as_jax")
    written = convert_checkpoint.main(["--config", CONFIG, "--device", "cpu", em.ckpt_dir,
                                       out_dir] + [f"{k}={v}" for k, v in over.items()])
    assert os.path.exists(os.path.join(written, "state.msgpack"))
    jm = JaxConformerCTC.from_config_file(
        CONFIG, overrides={**over, "trainer.resume_from_checkpoint": out_dir},
        dtype=jnp.float32)
    assert jm.fit(manifest, manifest, max_steps=3)["steps"] >= 1
    assert int(jm.state.step) == 3
    # and the file's weights are the port run's
    jm2 = JaxConformerCTC.from_config_file(CONFIG, overrides=over, dtype=jnp.float32)
    template = jm2._init_state(jm2._make_optimizer())
    restored, _ = jax_ckpt.restore_train_state(out_dir, template)
    sd = ctc_state_dict_from_jax(_host(restored), pm.cfg)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, sd[k]), k

    # the JAX package's run -> the port resumes it as it is
    jm = JaxConformerCTC.from_config_file(CONFIG, overrides=over, dtype=jnp.float32)
    jem = JaxExpManager(JaxExpManagerConfig(exp_dir=str(tmp_path / "jax"),
                                            create_tensorboard_logger=False))
    jm.fit(manifest, manifest, max_steps=2, exp_manager=jem)
    jem.wait_for_saves()
    pm = ConformerCTC.from_config_file(
        CONFIG, overrides={**over, "trainer.resume_from_checkpoint": jem.ckpt_dir},
        device="cpu", dtype=torch.float32)
    assert pm.fit(manifest, manifest, max_steps=3)["steps"] >= 1
    assert pm.train_state.step == 3
