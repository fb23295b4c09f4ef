"""Spectral transforms (``repro.spectral``): the Ozaki-Bailey FFT on the dispatch seam.

Every multiplication in this package is a matrix product routed through
``repro_torch.core.dispatch`` (dense DFT GEMMs up to ``dft.DENSE_MAX``, the
Bailey four-step factorisation above it), so the transforms keep the emulated
FP64 accuracy contract and the seam's routes.
"""

from repro_torch.spectral.bailey import choose_factors, dft_stacked
from repro_torch.spectral.dft import DENSE_MAX, dft_matrix, realified_dft, twiddle
from repro_torch.spectral.fft import (dft_error_bound, fft, fft2, fftn, ifft, ifft2,
                                      ifftn, irfft, rfft)

__all__ = [
    "DENSE_MAX", "choose_factors", "dft_error_bound", "dft_matrix",
    "dft_stacked", "fft", "fft2", "fftn", "ifft", "ifft2", "ifftn", "irfft",
    "realified_dft", "rfft", "twiddle",
]
