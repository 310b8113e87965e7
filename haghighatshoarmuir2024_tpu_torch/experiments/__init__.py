"""Measurement harnesses of the port, run on the card (``python -m
haghighatshoarmuir2024_tpu_torch.experiments.<name>``)."""
