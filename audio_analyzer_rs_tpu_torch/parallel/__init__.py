"""Batched analysis of many independent streams, on one card or shared over
a mesh of torch.distributed ranks (port of audio_analyzer_rs_tpu/parallel/).

`mesh.py` is the 1-D data-parallel mesh (`make_mesh`, `batch_sharding`,
`replicated`); `sharding.py` the full per-stream chain over a batch of B
streams (`make_batched_full_step`, one card or each rank its share with
the fleet statistics all-reduced) and the pooled wave shared over a mesh
(`make_pooled_wave_step`); `dryrun.py` the multichip dry run over gloo
processes on the CPU (`dryrun_multichip`, `run_world`).
"""

from .dryrun import dryrun_multichip, run_world
from .mesh import DATA_AXIS, batch_sharding, make_mesh, replicated
from .sharding import (FullStepOut, StreamStates, init_stream_states,
                       make_batched_full_step, make_pooled_wave_step)

__all__ = ["DATA_AXIS", "FullStepOut", "StreamStates", "batch_sharding",
           "dryrun_multichip", "init_stream_states", "make_batched_full_step",
           "make_mesh", "make_pooled_wave_step", "replicated", "run_world"]
