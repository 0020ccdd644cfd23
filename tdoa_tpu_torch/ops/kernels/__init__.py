"""Hand-written Hopper kernels and their wrappers, one per TPU kernel of
the JAX package.

``corr_accum.py`` replaces ``tdoa_tpu/ops/pallas/corr_accum.py``,
``zoom_probe.py`` replaces ``tdoa_tpu/ops/pallas/zoom_probe.py`` and
``fm_demod.py`` replaces ``tdoa_tpu/ops/pallas/fm_demod.py``; their CUDA
sources are ``tdoa_tpu_torch/csrc/*.cu``, built by ``_build.py``.
"""
