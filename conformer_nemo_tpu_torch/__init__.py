"""PyTorch/CUDA port of conformer_nemo_tpu for NVIDIA Hopper (H100).

The JAX package `conformer_nemo_tpu` stays the reference; this package
mirrors its module layout (audio/, config/, data/, decode/, models/, ops/,
convert/, api.py) so each port module sits at the same path as its
counterpart. It imports torch, never jax or the JAX package.

Entry points take `device=`; None means CUDA and raises when no GPU is
present. The CPU is used only when the caller asks for it (`device="cpu"`).
"""

from conformer_nemo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
