"""Hand-written Hopper kernels of the IQ main path and their wrappers.

``corr_accum.py`` replaces ``tdoa_tpu/ops/pallas/corr_accum.py`` and
``zoom_probe.py`` replaces ``tdoa_tpu/ops/pallas/zoom_probe.py``; their
CUDA sources are ``tdoa_tpu_torch/csrc/*.cu``, built by ``_build.py``.
"""
