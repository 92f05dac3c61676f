"""Convert a resumable checkpoint between the JAX package's format
(`step_N/state.msgpack`) and the port's (`step_N/state.pt`), so that either
package resumes the other's run.

    python -m conformer_nemo_tpu_torch.scripts.convert_checkpoint \
        --config configs/conformer_ctc_bpe.yaml [--device cpu] \
        IN OUT [model.encoder.n_layers=2 ...]

IN is a checkpoint directory (its `last` step is read) or one `step_N`
directory; the format is the one its step directory holds. OUT is a
checkpoint directory: the step is written to OUT/step_N in the other
format, with `meta.json` copied and OUT/last pointing at it. The config
(with the run's overrides) gives the model and the optimizer: its
`model.optim` name, `trainer.gradient_clip_val` and
`trainer.accumulate_grad_batches` must be the run's. The random stream
crosses by a rule, not exactly (convert/jax_train_state.py).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.scripts.common import add_device_arg, parse_overrides


def _step_dir(path: str) -> str:
    last = os.path.join(path, "last")
    if os.path.exists(last):
        with open(last) as f:
            return os.path.join(path, f.read().strip())
    return path


def convert(config: str, in_path: str, out_dir: str, overrides: Optional[dict] = None,
            device=None, model_type: str = "auto") -> str:
    """-> the written step directory."""
    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
    from conformer_nemo_tpu_torch.config.loader import load_config
    from conformer_nemo_tpu_torch.convert import jax_train_state
    from conformer_nemo_tpu_torch.train import checkpoint

    if model_type == "auto":
        model_type = "rnnt" if "joint" in load_config(config, overrides or {})["model"] else "ctc"
    cls = ConformerTransducer if model_type == "rnnt" else ConformerCTC
    model = cls.from_config_file(config, overrides=overrides or {}, device=device)
    state = model._init_state(model._make_optimizer())
    step_dir = _step_dir(in_path)
    from_jax = not os.path.exists(os.path.join(step_dir, checkpoint.STATE_FILE))
    step = int(os.path.basename(os.path.normpath(step_dir)).split("_")[-1])
    restored, _ = checkpoint.restore_train_state(os.path.dirname(os.path.normpath(step_dir)),
                                                 state, step=step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {in_path}")
    out = os.path.join(out_dir, f"step_{state.step}")
    os.makedirs(out, exist_ok=True)
    if from_jax:
        checkpoint.save_train_state(out_dir, state, state.step)
    else:
        tr = model.raw_cfg.get("trainer", {})
        optim = (model.raw_cfg["model"].get("optim") or {}).get("name", "adamw")
        jax_train_state.write_train_state(os.path.join(out, jax_train_state.STATE_FILE), state,
                                          optim, tr.get("gradient_clip_val"))
        with open(os.path.join(out_dir, "last"), "w") as f:
            f.write(f"step_{state.step}")
    shutil.copy(os.path.join(step_dir, "meta.json"), os.path.join(out, "meta.json"))
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    overrides, leftover = parse_overrides(sys.argv[1:] if argv is None else list(argv))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--model-type", default="auto", choices=("auto", "ctc", "rnnt"))
    ap.add_argument("input")
    ap.add_argument("output")
    add_device_arg(ap)
    args = ap.parse_args(leftover)
    out = convert(args.config, args.input, args.output, overrides, args.device, args.model_type)
    print(f"wrote {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
