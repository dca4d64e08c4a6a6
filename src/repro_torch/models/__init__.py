"""LM substrate of the port: configs, attention, the dense transformer."""
