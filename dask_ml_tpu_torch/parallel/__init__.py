"""Staging and telemetry of the PyTorch port (single device)."""
