"""Command-line entry points (ports of the repo's scripts/): training,
transcription and evaluation, each `python -m
conformer_nemo_tpu_torch.scripts.<name> ...` with a `main(argv=None)`."""
