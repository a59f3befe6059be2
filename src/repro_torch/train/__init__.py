"""PEFT-masked training of the PyTorch port: the train step and the
checkpoint format shared with the reference package."""
