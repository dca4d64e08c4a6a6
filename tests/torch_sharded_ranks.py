"""Rank programs of tests/test_torch_sharded.py: gloo ranks spawned on the
CPU, each running the port's engines on cases the test hands over as plain
data (`test_torch_harness.port_spec`), and saving what it saw.  Imports
no JAX, so a rank starts in a few seconds.

`spawn_ranks` starts the ranks, joins them by a deadline, stops any that
is still alive and fails unless every rank exited 0: a rank that raised
leaves the others in a collective until the group's 60 s timeout, never
the suite's limit.
"""
from __future__ import annotations

import multiprocessing as mp
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_DEADLINE_S = 150


def spawn_ranks(tmp_path: Path, world: int, cases: list[dict]) -> list:
    """Run `cases` on `world` gloo ranks; returns each rank's results (a
    list of per-case dicts, see `run_case`)."""
    torch.save(cases, tmp_path / "cases.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert not hung and codes == [0] * world, (
        f"ranks hung {hung}, exit codes {codes}")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        cases = torch.load(f"{tmp}/cases.pt", weights_only=False)
        torch.save([run_case(c) for c in cases], f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_case(case: dict) -> dict:
    """One simulator of `case["spec"]` on `case["engine"]` (with
    `n_shards` when given): a run_raw, a run_batch, and with `reward` the
    commit and a warm run from the committed indexes."""
    from test_torch_harness import port_from_spec

    sim = port_from_spec(case["spec"], case["engine"], "cpu",
                         faults=case.get("faults"), trace=case.get("trace"),
                         plasticity=case.get("plasticity"))
    if case["engine"] == "sharded":
        eng = sim.sharded_engine(case.get("n_shards"))
    else:
        eng = sim.array_engine()
    trains = torch.as_tensor(case["trains"])
    ys, counts = eng.run_raw(trains)
    out = {"ys": ys, "counts_raw": counts,
           "sharded": eng.last_run_sharded,
           "n_shards": getattr(eng, "n_shards", None),
           "exchange_bytes": eng.last_exchange_bytes}
    out["counts"], out["reports"] = sim.run_batch(trains)
    out["learned"] = sim.last_learned
    out["trace"] = sim.last_trace()
    if case.get("reward") is not None:
        out["reward_info"] = sim.apply_reward(case["reward"])
        out["committed"] = sim.last_learned
        out["warm_counts"], out["warm_reports"] = sim.run_batch(
            trains, learned=sim.last_learned)
    return out
