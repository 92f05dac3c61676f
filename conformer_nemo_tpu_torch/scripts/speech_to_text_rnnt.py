"""Train a Conformer-Transducer model (char or BPE vocabulary).

    python -m conformer_nemo_tpu_torch.scripts.speech_to_text_rnnt \
        --config configs/conformer_transducer_bpe.yaml [--device cpu] \
        model.train_ds.manifest_filepath=train.json \
        model.validation_ds.manifest_filepath=val.json [+fast_dev_run=true]

On N GPUs, one process each (the global batch is N x batch_size):

    torchrun --nproc-per-node N -m conformer_nemo_tpu_torch.scripts.speech_to_text_rnnt ...
"""

from __future__ import annotations

from typing import Optional, Sequence

from conformer_nemo_tpu_torch.api import ConformerTransducer
from conformer_nemo_tpu_torch.scripts.common import train


def main(argv: Optional[Sequence[str]] = None):
    """-> (model, fit result)."""
    return train(ConformerTransducer, "configs/conformer_transducer_bpe.yaml", argv)


if __name__ == "__main__":
    main()
