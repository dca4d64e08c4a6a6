"""Distributed runtime of the port: the elastic training loop's straggler
policy and checkpoint/restart (`elastic.py`).  The reference's mesh
sharding, collectives and `ElasticPlan` (a jax mesh per device count)
wait for ROADMAP Queue 1 #21."""
