"""tdoa_tpu_torch — the PyTorch + CUDA (Hopper) port of ``tdoa_tpu``.

The IQ main path of the JAX package, module for module: the ``.dat``
codec decodes on the device, a hand-written CUDA kernel runs the
segment FFT, cross-spectra and banked accumulation
(``ops/kernels/corr_accum.py``), a second one the split-σ leave-one-out
zoom probe (``ops/kernels/zoom_probe.py``), and plain torch
(``complex64``, ``torch.fft``) runs the finish stage, the clock
correction and the solver. CPU tensors take each kernel's plain torch
version, so the whole path runs, and is tested, without a card. Beside
it: FM mode (kernel 3, ``ops/kernels/fm_demod.py``), streaming and
overlapped ingest, the CAF, audio-pattern matching, the scene simulator
(``sim/``), capture quality (``quality/``, ``dsp/snr.py``), gain
calibration (``calib/``), stage timing and tracing
(``utils/profiling.py``) and the command-line tools (``cli/``).

This package imports ``torch`` and numpy, never ``jax`` or ``tdoa_tpu``.
"""

__version__ = "0.1.0"

from tdoa_tpu_torch.utils.constants import DEFAULT_SAMPLE_RATE, SPEED_OF_LIGHT

__all__ = ["SPEED_OF_LIGHT", "DEFAULT_SAMPLE_RATE", "__version__"]
