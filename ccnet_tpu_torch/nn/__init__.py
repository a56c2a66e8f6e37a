from ccnet_tpu_torch.nn.layers import ABN, Conv

__all__ = ["ABN", "Conv"]
