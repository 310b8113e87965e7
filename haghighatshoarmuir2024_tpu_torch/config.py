"""Global constants (counterpart of ``haghighatshoarmuir2024_tpu/config.py``).

The reference hard-codes these per module (micloc/beamformer.py:23
``Fs = 48_000``, micloc/array_geometry.py:14 ``SOUND_SPEED_IN_OPEN_AIR``).
"""

# Sampling rate of the 7-mic dev board (reference: micloc/beamformer.py:23).
FS = 48_000

# Speed of sound (reference: micloc/array_geometry.py:14).
SOUND_SPEED_IN_OPEN_AIR = 340.0
