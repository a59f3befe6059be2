"""Entry points of the PyTorch port: the training launcher
(:mod:`repro_torch.launch.train`)."""
