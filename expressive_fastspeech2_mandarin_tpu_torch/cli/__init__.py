"""Command-line entry points of the port (``efs2-torch-*``, or ``python -m
expressive_fastspeech2_mandarin_tpu_torch.cli.<name>``)."""
