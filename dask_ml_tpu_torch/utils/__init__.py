"""Validation helpers of the PyTorch port."""
