"""Losses of the PyTorch port."""
