"""The plain reference that decides ``correct``: plain NumPy and PyTorch,
independent of the sampler under test."""
