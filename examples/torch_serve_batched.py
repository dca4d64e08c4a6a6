"""Serve a small LM with batched requests on the PyTorch port — the serving
loop (the paper is an edge-inference chip, so serving is its
LM-framework analogue).  Port of examples/serve_batched.py: prefill and
batched greedy decode on the meshed `Server` (a ("data", "model") mesh
of this process, `launch/mesh.py` `make_host_mesh`), the C3
quantized-weight serving mode, then the neuromorphic path: event-stream
requests served through the batched chip engine (`serve/snn_server.py`)
and a second network as a co-resident tenant.  Runs on the card unless
--device cpu.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py
      PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import noc as NOC
from repro_torch.core.soc import ChipSimulator, remap_mapping_cores
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig
from repro_torch.quant import lm_quant as Q
from repro_torch.serve import SnnRequest, SnnServer
from repro_torch.serve.server import Request, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    try:
        return _serve(dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _serve(dev) -> dict:
    cfg = ArchConfig("serve-demo", "dense", n_layers=4, d_model=256,
                     n_heads=8, n_kv_heads=4, d_ff=512, vocab=1024,
                     dtype=torch.float32)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    # C3 indexes and codebooks, fitted before the server lays `params` out
    qparams = Q.quantize_blocks(params)
    mesh = make_host_mesh(device=dev)
    srv = Server(cfg, params, batch_slots=4, cache_len=128, mesh=mesh)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for uid in range(8):
        srv.submit(Request(uid=uid,
                           prompt=rng.integers(0, 1024, 12).astype(np.int32),
                           max_new_tokens=16))
    done = srv.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s on {dev.type}, mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))})")
    for r in done[:3]:
        print(f"  req {r.uid}: {r.out_tokens[:8]}...")

    # C3: quantized-weight serving (int8 indexes read instead of f32
    # weights; the products on the codebook_matmul kernel)
    before, after = Q.quantized_bytes(qparams)
    qsrv = Server(dataclasses.replace(cfg, quant_serving=True), qparams,
                  batch_slots=4, cache_len=32, mesh=mesh)
    qsrv.submit(Request(uid=0, prompt=np.array([1, 2, 3, 4], np.int32),
                        max_new_tokens=1))
    first = qsrv.run()[0].out_tokens[0]
    print(f"quantized serving: weight bytes {before/2**20:.1f}MiB -> "
          f"{after/2**20:.1f}MiB, next-token argmax {first}")

    # -- neuromorphic serving: event streams on the batched chip engine --
    w = [rng.normal(0, 0.4, (288, 256)).astype(np.float32),
         rng.normal(0, 0.4, (256, 10)).astype(np.float32)]
    # greedy mapping packs the net onto a minimal contiguous core slice,
    # leaving free cores for the second tenant below
    sim = ChipSimulator(w, freq_hz=100e6, engine="compiled",
                        mapping_strategy="greedy", device=dev)
    snn = SnnServer(sim, batch_slots=8)
    for uid in range(12):
        snn.submit(SnnRequest(
            uid=uid, events=(rng.random((16, 288)) < 0.1).astype(np.float32)))
    t0 = time.time()
    served = snn.run()
    dt = time.time() - t0
    pj = sum(r.energy_pj for r in served)
    print(f"snn serving: {len(served)} event requests in {dt*1e3:.0f} ms "
          f"({len(served)/max(dt, 1e-9):.0f} req/s incl. compile), "
          f"{pj/len(served)/1e3:.1f} nJ/request, "
          f"pJ/SOP {served[0].pj_per_sop:.3f}, "
          f"host DMA {served[0].dma_pj/1e3:.1f} nJ/request")

    # -- multi-model tenancy: a second net on a disjoint core slice --
    w2 = [rng.normal(0, 0.4, (288, 128)).astype(np.float32),
          rng.normal(0, 0.4, (128, 10)).astype(np.float32)]
    tiny = ChipSimulator(w2, engine="compiled", mapping_strategy="greedy",
                         device=dev)
    free = [int(c) for c in NOC.core_ids()
            if int(c) not in snn.tenants["default"].core_ids]
    need = len(tiny.mapping.active_core_ids())
    aux = ChipSimulator(w2, engine="compiled", device=dev,
                        mapping=remap_mapping_cores(tiny.mapping,
                                                    free[:need]))
    snn.add_model("aux", aux)
    for uid in range(8):
        snn.submit(SnnRequest(
            uid=100 + uid, model="aux", deadline_ms=500.0,
            events=(rng.random((16, 288)) < 0.1).astype(np.float32)))
    snn.run()
    host = snn.host_summary()
    print(f"tenancy: aux model on cores "
          f"{sorted(snn.tenants['aux'].core_ids)}, "
          f"{host['model_swaps']:.0f} table-load DMAs "
          f"({host['swap_pj']/1e3:.1f} nJ reconfiguration)")
    print(snn.metrics.expose().splitlines()[0])
    return {"lm": done, "c3_first_token": first, "snn": served,
            "host": host}


if __name__ == "__main__":
    main()
