"""Harnesses of the port, on the card unless ``--device cpu`` is given
(``python -m haghighatshoarmuir2024_tpu_torch.experiments.<name>``): the
roofline measurements, the Xylo accuracy, convention and energy
experiments, the paper's accuracy, beam-pattern, multi-target and
robustness harnesses of the classical families and the float SNN, and the
harnesses that time and check the ported paths (the flagship attribution,
serving, reduced rate, three bands, the wire codecs, the design's cold
start, instantaneous phase, the live-style benchmark and its analysis, the
reverberant room)."""
