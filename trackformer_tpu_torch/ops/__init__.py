"""Tensor ops of the port: MSDA (with its CUDA kernel), box geometry, NMS
and assignment."""
