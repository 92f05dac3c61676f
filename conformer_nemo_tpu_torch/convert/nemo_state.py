"""A NeMo Conformer state_dict onto the port's modules (the counterpart of
conformer_nemo_tpu/convert/nemo_weights.py).

The port's modules carry NeMo's state_dict names and layouts, so nothing
is transposed: `nemo_state_dict` renames what differs and names what it
drops.

- The joint's output Linear: NeMo's `joint.joint_net` is [activation,
  (dropout), Linear], so the Linear is index 1 without joint dropout and 2
  with it; the port's is always 2. The largest index is taken, as the JAX
  converter takes it.
- The LSTM's `bias_ih_l{k}` + `bias_hh_l{k}` pair loads as it is: the
  port's prediction network sums it and subtracts the forget-gate
  constant c, into the one bias it trains (the JAX package's leaf b - c).
- Dropped: BatchNorm's `num_batches_tracked`, the preprocessor's
  `featurizer.fb` / `featurizer.window` buffers (the port builds its mel
  basis from the config), and any other entry the model has no place for.

Every subsampling mode loads: the front ends' modules carry NeMo's
indices (`pre_encode.conv.{i}`, a ResNetBlock's `conv1`/`batchnorm1`, a
stacking `pre_encode.proj_out`, the factor-1 `pre_encode` Linear).
"""

from __future__ import annotations

import re

from torch import nn

_JOINT_OUT = re.compile(r"^joint\.joint_net\.(\d+)\.(weight|bias)$")


def nemo_state_dict(sd: dict, model: nn.Module) -> tuple:
    """NeMo state_dict `sd` -> (the state_dict `model` loads strictly, the
    sorted names of `sd` it drops). Raises KeyError naming the model's
    entries `sd` lacks."""
    joint = [int(m.group(1)) for m in map(_JOINT_OUT.match, sd) if m]
    last = max(joint, default=None)
    names = {}  # the port's name -> NeMo's
    for k in sd:
        m = _JOINT_OUT.match(k)
        names[f"joint.joint_net.2.{m.group(2)}" if m and int(m.group(1)) == last else k] = k
    want = model.state_dict()
    missing = sorted(k for k in want if k not in names)
    if missing:
        raise KeyError(f"the NeMo state_dict lacks {len(missing)} of the model's entries: "
                       f"{missing[:8]}")
    return ({k: sd[names[k]] for k in want},
            sorted(nemo for port, nemo in names.items() if port not in want))
