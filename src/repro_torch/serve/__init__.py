"""Serving on the port: SNN event-stream serving (`snn_server.py`, with
admission control and dispatch resilience) and LM serving (`server.py`:
batched prefill + greedy decode on one card)."""
from repro_torch.serve.admission import (CREATED, DEADLINE_EXCEEDED, QUEUED,
                                         SERVED, SHED, SnnRequest)
from repro_torch.serve.snn_server import SnnServer, Tenant

__all__ = ["SnnRequest", "SnnServer", "Tenant", "CREATED", "QUEUED",
           "SERVED", "SHED", "DEADLINE_EXCEEDED"]
