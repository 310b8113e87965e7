"""Live localization demos (counterpart of ``haghighatshoarmuir2024_tpu/demos``;
the application layer, reference L7): the Hilbert, float-SNN, MUSIC,
SRP-PHAT and quantized-Xylo loops over an audio source with the
ring-buffer visualizer.  Each module has ``Demo``, ``run_demo`` at the
reference's defaults and a ``__main__``; they run on the card unless
``device="cpu"``."""

from . import localization_demo
from . import localization_demo_snn
from . import localization_demo_music
from . import localization_demo_xylo
from . import localization_demo_srp

__all__ = [
    "localization_demo",
    "localization_demo_snn",
    "localization_demo_music",
    "localization_demo_xylo",
    "localization_demo_srp",
]
