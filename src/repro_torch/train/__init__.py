"""Training of the port: the hardware-aware SNN trainer and the LM
trainer."""
