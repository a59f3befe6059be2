"""Dense decoder of the PyTorch port (layers, attention, model)."""
