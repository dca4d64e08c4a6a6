"""Training of the port: the hardware-aware SNN trainer."""
