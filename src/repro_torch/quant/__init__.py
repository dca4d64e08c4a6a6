"""LM weight quantization of the port: C3 codebook serving
(`lm_quant`)."""
