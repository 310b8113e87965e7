"""Harnesses of the port, on the card unless ``--device cpu`` is given
(``python -m haghighatshoarmuir2024_tpu_torch.experiments.<name>``): the
roofline measurements and the Xylo accuracy, convention and energy
experiments."""
