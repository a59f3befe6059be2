"""PEFT core of the PyTorch port: Cayley map, PSOFT, LoRA, the method
registry with its adapter banks, and the dispatcher."""
