"""LM serving of the port: batched prefill + greedy decode on one card."""
