"""RNG-DISCIPLINE true negatives: an allowlisted init path, seeded
generators passed explicitly, and draws that mint nothing.

Parsed by the rule engine in tests, never imported or executed.
"""
import torch


def lora_init(shape, seed):
    gen = torch.Generator()                   # allowlisted: *init* qualname
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen)


def perturb(x, gen):
    noise = torch.randn(x.shape, generator=gen)        # seeded elsewhere
    x.uniform_(generator=gen)
    return x + noise, torch.argmax(x, dim=-1)
