"""The plain reference: exact k nearest neighbours in plain PyTorch. It
imports nothing of ``pynndescent_torch`` and takes nothing the program made."""
