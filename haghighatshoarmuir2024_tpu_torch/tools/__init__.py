"""User-facing command-line tools (counterpart of ``haghighatshoarmuir2024_tpu/tools``)."""
