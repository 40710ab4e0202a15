"""Bitmap word operations and the batched device kernels."""
