"""Counterparts of haghighatshoarmuir2024_tpu/utils."""
