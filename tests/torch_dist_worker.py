"""One rank of the port's distributed CPU tests (gloo), JAX-free.

    python tests/torch_dist_worker.py SPEC.json RANK

SPEC names a scenario and its inputs (weights and batches that the test
wrote from numpy), the world size and the rendezvous port: that of a store
the spawning process holds (`run_world`), which the ranks join as clients. The worker
joins the process group through the port's `initialize_distributed`
(one-minute collective timeout), runs the scenario on its rows and writes
`torch.save` of its results to SPEC["out"] with {rank} filled in.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from conformer_nemo_tpu_torch.parallel import distributed as pdist  # noqa: E402
from conformer_nemo_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from conformer_nemo_tpu_torch.parallel.sharding import full_state_dict  # noqa: E402


def _optimizer(spec, mesh):
    from conformer_nemo_tpu_torch.train import lr_schedule, optim

    return optim.make_optimizer(
        spec.get("optim", "adamw"), lr_schedule.make_lr_schedule(spec["sched"], spec["lr"]),
        weight_decay=1e-3, betas=(0.9, 0.98), grad_clip=spec.get("grad_clip"),
        grad_norm=mesh.grad_norm, model_group=mesh.model_group if mesh.model > 1 else None)


def _rows(batch: dict, mesh) -> dict:
    """This rank's slice of a global batch: the data index's share of rows."""
    b = batch["audio"].shape[0] // mesh.data
    return {k: v[mesh.data_index * b: (mesh.data_index + 1) * b] for k, v in batch.items()}


def _ctc_state(spec, mesh):
    from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
    from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
    from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig
    from conformer_nemo_tpu_torch.train.trainer import init_ctc_state, make_ctc_train_step

    cfg = CTCModelConfig(preprocessor=MelFeatureConfig(features=spec["enc"]["feat_in"],
                                                       dither=0.0),
                         encoder=ConformerEncoderConfig(dtype=torch.float32, **spec["enc"]),
                         num_classes=spec["vocab"])
    model = CTCModel(cfg)
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    opt = _optimizer(spec, mesh)
    return init_ctc_state(model, opt), make_ctc_train_step(cfg, opt)


def _rnnt_state(spec, mesh):
    from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
    from conformer_nemo_tpu_torch.models import rnnt
    from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
    from conformer_nemo_tpu_torch.train.rnnt_trainer import (
        RNNTTrainConfig,
        init_rnnt_state,
        make_rnnt_train_step,
    )

    f32 = torch.float32
    cfg = RNNTTrainConfig(
        preprocessor=MelFeatureConfig(features=spec["enc"]["feat_in"], dither=0.0),
        model=rnnt.RNNTModelConfig(
            encoder=ConformerEncoderConfig(dtype=f32, **spec["enc"]),
            decoder=rnnt.RNNTDecoderConfig(dtype=f32, **spec["dec"]),
            joint=rnnt.RNNTJointConfig(dtype=f32, **spec["joint"]),
            joint_impl=spec.get("joint_impl", "auto")))
    model = rnnt.RNNTModel(cfg.model)
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    opt = _optimizer(spec, mesh)
    return init_rnnt_state(model, opt, seed=spec.get("seed", 0)), make_rnnt_train_step(cfg, opt)


def steps(spec, rank):
    """Train steps over the global batches on the mesh; -> per-step metrics,
    the local and the gathered state_dicts."""
    from conformer_nemo_tpu_torch.train import checkpoint
    from conformer_nemo_tpu_torch.train.trainer import distribute_state

    mesh = make_mesh(spec["data"], spec["model"])
    state, step = (_ctc_state if spec["family"] == "ctc" else _rnnt_state)(spec, mesh)
    distribute_state(state, mesh)
    if spec.get("resume"):
        checkpoint.restore_train_state(spec["resume"], state)
    out = {"metrics": [], "mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index)}
    for i, path in enumerate(spec["batches"]):
        batch = _rows(dict(np.load(path)), mesh)
        m = step(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if spec.get("save_at") == i + 1:
            checkpoint.save_train_state(spec["ckpt_dir"], state, state.step)
            out["saved"] = {k: v.clone() for k, v in full_state_dict(state.model).items()}
    out["local"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    out["full"] = full_state_dict(state.model)
    out["step"] = state.step
    return out


def batchnorm(spec, rank):
    """The conv module's BatchNorm, synchronised over the world: this rank's
    rows of x [B, C, T], the training forward, the backward of sum(y * w)."""
    from conformer_nemo_tpu_torch.models.conformer import BatchNorm

    mesh = make_mesh()
    data = dict(np.load(spec["inputs"]))
    x = torch.from_numpy(_rows({"audio": data["x"]}, mesh)["audio"]).requires_grad_(True)
    w = torch.from_numpy(_rows({"audio": data["w"]}, mesh)["audio"])
    bn = BatchNorm(x.shape[1]).train()
    bn.sync_group = mesh.data_group
    y, stats = bn(x)
    bn.update_running_stats(stats)
    (y * w).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


BATCH_ARRAYS = ("audio", "audio_lens", "tokens", "token_lens")


def record_batches(model) -> list:
    """Wrap the model's train step so that it keeps a host copy of every
    batch it takes; -> the list they go into."""
    seen: list = []
    make = model._make_train_step

    def recording(optimizer):
        step = make(optimizer)

        def take(batch):
            seen.append({k: getattr(batch, k).cpu().numpy().copy() for k in BATCH_ARRAYS})
            return step(batch)

        return take

    model._make_train_step = recording
    return seen


def fit(spec, rank):
    """ConformerCTC.fit through the API on the config and manifest of the
    spec (spec["epochs"] epochs), with an experiment manager, keeping the
    batches its steps take; then a mesh that does not fit."""
    import logging

    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.train.exp_manager import ExperimentManager, ExpManagerConfig

    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logging.getLogger("conformer_nemo_tpu_torch").addHandler(handler)
    logging.getLogger("conformer_nemo_tpu_torch").setLevel(logging.INFO)
    model = ConformerCTC.from_config_file(spec["config"], overrides=spec["overrides"],
                                          device="cpu", dtype=torch.float32)
    loader = model._loader(spec["manifest"], model.raw_cfg["model"]["train_ds"], shuffle=True,
                           mesh=make_mesh())
    local_len = len(loader._rank_plan(loader.process_index))  # the whole plan, before the cut
    em = ExperimentManager(ExpManagerConfig(exp_dir=spec["exp_dir"], name="dist",
                                            create_tensorboard_logger=False))
    seen = record_batches(model)
    result = model.fit(spec["manifest"], spec["manifest"], max_epochs=spec["epochs"],
                       exp_manager=em)
    out = {"result": result, "local_len": local_len, "log": records, "run_dir": em.run_dir,
           "state": {k: v.clone() for k, v in model.state_dict().items()}, "batches": seen}
    if spec.get("tar_overrides"):  # a stream of unknown length: the ranks agree each step
        tarred = ConformerCTC.from_config_file(
            spec["config"], overrides={**spec["overrides"], **spec["tar_overrides"]},
            device="cpu", dtype=torch.float32)
        out["tar_steps"] = tarred.fit(spec["manifest"], max_epochs=1)["steps"]
        out["log"] = list(records)
    try:
        bad = ConformerCTC.from_config_file(
            spec["config"], overrides={**spec["overrides"], "trainer.mesh": {"data": 3}},
            device="cpu", dtype=torch.float32)
        bad.fit(spec["manifest"], max_steps=1)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def cli(spec, rank):
    """The CTC training script under the launcher's environment: its
    stdout, its fit result and the archive it names."""
    import contextlib
    import io

    from conformer_nemo_tpu_torch.scripts import speech_to_text_ctc

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, result = speech_to_text_ctc.main(spec["argv"])
    return {"stdout": out.getvalue(), "result": result}


SCENARIOS = {"steps": steps, "batchnorm": batchnorm, "fit": fit, "cli": cli}


def _agent_store(world: int):
    """The world's rendezvous store, held by the test process as torchrun's
    agent holds it: bound to a port the system picks before any rank learns
    the port; the ranks join it as clients (TORCHELASTIC_USE_AGENT_STORE)."""
    import datetime

    return torch.distributed.TCPStore("localhost", 0, world, is_master=True,
                                      wait_for_workers=False,
                                      timeout=datetime.timedelta(seconds=60))


def run_world(tmp_dir: str, scenario: str, world: int, timeout: float = 240, **spec) -> list:
    """Spawn `world` ranks of this worker on `scenario` and wait for them
    (each under `timeout` seconds, then every rank is killed and the test
    fails); -> each rank's results."""
    import subprocess

    store = _agent_store(world)
    port = store.port
    spec = {**spec, "scenario": scenario, "world": world, "port": port,
            "out": os.path.join(tmp_dir, f"{scenario}_{port}_rank{{rank}}.pt")}
    path = os.path.join(tmp_dir, f"{scenario}_{port}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(rank)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        del store
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}\n{err[-3000:]}"
    return [torch.load(spec["out"].format(rank=r), weights_only=False) for r in range(world)]


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(spec["port"]),
                      WORLD_SIZE=str(spec["world"]), RANK=str(rank), LOCAL_RANK=str(rank),
                      TORCHELASTIC_USE_AGENT_STORE="True")
    pdist.initialize_distributed(device="cpu", timeout_s=60)
    out = SCENARIOS[spec["scenario"]](spec, rank)
    torch.save(out, spec["out"].format(rank=rank))
    pdist.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
