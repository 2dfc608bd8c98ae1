"""The benchmark of the PyTorch and CUDA port (gcn_tpu_torch): see README.md."""
