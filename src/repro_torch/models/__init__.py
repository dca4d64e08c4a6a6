"""Models of the port: the SNN MLP (`snn`) and conv SNN (`snn_conv`) with
BPTT, and the LM substrate (configs, attention, the dense transformer)."""
