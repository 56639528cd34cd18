"""Model modules of the PyTorch port (NCHW inside, NHWC at the public API)."""
