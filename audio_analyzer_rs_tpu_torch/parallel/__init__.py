"""Batched analysis of many independent streams (port of
audio_analyzer_rs_tpu/parallel/).

`sharding.make_batched_full_step` is the full per-stream chain over a
batch of B streams on one card.  The JAX package shards that batch over a
device mesh (`mesh.py`); the mesh is not ported yet, so the step takes
`mesh=None`.
"""
