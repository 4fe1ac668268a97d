"""Functional model cores of the PyTorch port."""
