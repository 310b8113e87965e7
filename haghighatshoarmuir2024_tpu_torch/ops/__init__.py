"""Counterparts of haghighatshoarmuir2024_tpu/ops: the names the JAX
package's ``ops`` exports, where the port has them."""

from .batching import chunked_vmap  # noqa: F401  (public; outside __all__, which lists JAX ops' names)
from .envelope import Envelope
from .filterbank import ButterworthFilterbank, Filterbank
from .fir import fir_filter, moving_average_full
from .iir import butter_bandpass, iir_filter
from .interp import delayed_copies, interp_uniform, received_signal, resample_to_fs, signal_from_template
from .lif import lif_filter, lif_impulse_response
from .linalg import dc_removed_sing_vec, fold_complex_cov, generalized_top_eigvec, top_eigvec_psd, unfold_complex_vec
from .peaks import find_peaks_mask, local_maxima_mask, select_by_distance
from .spikes import (IAFSpikeEncoder, IAFZeroCrossingSpikeEncoder, PeakSpikeEncoder, SpikeEncoder,
                     ZeroCrossingSpikeEncoder, rzcc_encode)
from .stht import stht, stht_kernel

__all__ = [
    "fir_filter",
    "moving_average_full",
    "butter_bandpass",
    "iir_filter",
    "stht",
    "stht_kernel",
    "delayed_copies",
    "interp_uniform",
    "received_signal",
    "resample_to_fs",
    "signal_from_template",
    "find_peaks_mask",
    "local_maxima_mask",
    "select_by_distance",
    "SpikeEncoder",
    "IAFSpikeEncoder",
    "IAFZeroCrossingSpikeEncoder",
    "ZeroCrossingSpikeEncoder",
    "PeakSpikeEncoder",
    "rzcc_encode",
    "top_eigvec_psd",
    "dc_removed_sing_vec",
    "generalized_top_eigvec",
    "fold_complex_cov",
    "unfold_complex_vec",
    "lif_filter",
    "lif_impulse_response",
    "Envelope",
    "Filterbank",
    "ButterworthFilterbank",
]
