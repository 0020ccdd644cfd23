"""The benchmark of ``tdoa_tpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (README.md)."""
