"""Hand-written Hopper kernels and their wrappers: one per TPU kernel of
the JAX package, and one for the solve's LM loop.

``corr_accum.py`` replaces ``tdoa_tpu/ops/pallas/corr_accum.py``,
``zoom_probe.py`` replaces ``tdoa_tpu/ops/pallas/zoom_probe.py`` and
``fm_demod.py`` replaces ``tdoa_tpu/ops/pallas/fm_demod.py``;
``lm_solve.py`` replaces no Pallas kernel: it runs the jitted LM loop of
``tdoa_tpu/solve/multilateration.py`` in one launch. Their CUDA sources
are ``tdoa_tpu_torch/csrc/*.cu``, built by ``_build.py``.
"""
