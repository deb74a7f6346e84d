"""Serve plane and streaming engine of the PyTorch port."""
