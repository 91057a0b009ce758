"""The benchmark of ddsp_tpu_torch on NVIDIA H100s (``python3 benchmark/run.py``)."""
