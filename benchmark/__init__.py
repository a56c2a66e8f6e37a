"""The benchmark of ``ccnet_tpu_torch`` on NVIDIA H100 cards (see README.md)."""
