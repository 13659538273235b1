"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command, ``python3 bench/run.py``, driven by the files under
``bench/configs``, ``bench/workloads`` and ``bench/metrics``."""
