"""Harnesses of the port, on the card unless ``--device cpu`` is given
(``python -m haghighatshoarmuir2024_tpu_torch.experiments.<name>``): the
roofline measurements, the Xylo accuracy, convention and energy
experiments, and the paper's accuracy, beam-pattern, multi-target and
robustness harnesses of the classical families and the float SNN."""
