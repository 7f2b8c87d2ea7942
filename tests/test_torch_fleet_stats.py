"""The full step's fleet floor in the form XLA gives the JAX step's
`psum(sum(gf_db)) / total_b` (parallel/sharding.py `fleet_statistics`):
the per-device sums added in device order, then multiplied by 1 / total_b
rounded to float32.  Held bit for bit against the JAX package's step on 1
and 8 devices of its virtual CPU mesh (tests/conftest.py), at batches where
a float32 division by total_b would round differently (B = 3 and 40), from
the JAX step's own per-stream floors.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.parallel import sharding as jsh
from audio_analyzer_rs_tpu.parallel.mesh import batch_sharding, make_mesh
from audio_analyzer_rs_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

SR, CHUNK = 48000.0, 4096


@pytest.fixture(scope="module")
def single():
    step = partial(jsh._single_stream_step, sample_rate=SR, slot_len=1024,
                   pitch_hop=512, onset_hop=64)
    return jax.jit(step), jax.tree.map(lambda a: a[0],
                                       jsh.init_stream_states(1))


@pytest.mark.parametrize("n_dev,batch", [(1, 3), (8, 40)])
def test_fleet_floor_takes_xlas_form(single, n_dev, batch):
    rng = np.random.default_rng(n_dev * 100 + batch)
    audio = (rng.standard_normal((batch, CHUNK))
             * rng.uniform(0.001, 0.5, (batch, 1))).astype(np.float32)
    mesh = make_mesh(jax.devices()[:n_dev])
    sh = batch_sharding(mesh)
    st = jsh.init_stream_states(batch)
    st = jax.device_put(st, jax.tree.map(lambda _: sh, st))
    _, out = jsh.make_batched_full_step(mesh, SR)(
        st, jax.device_put(audio, sh))
    want = np.float32(out.global_noise_floor_db)

    step, s1 = single
    per = [step(s1, jnp.asarray(a))[1] for a in audio]
    gf = torch.from_numpy(np.array([np.asarray(p[5]) for p in per],
                                   np.float32))
    fired = torch.from_numpy(np.stack([np.asarray(p[2]) for p in per]))
    loc = batch // n_dev

    def device_sums(t, part):
        """The devices' partial sums of `part`, added in device order (the
        psum of the JAX step), whatever this device's own value `t`."""
        acc = part(0)
        for k in range(1, n_dev):
            acc = acc + part(k)
        return acc.reshape(t.shape).to(t.dtype)

    def psum(t):
        if t.dtype == torch.float32:
            return device_sums(t, lambda k: gf[k * loc:(k + 1) * loc].sum())
        return device_sums(t, lambda k: torch.stack([
            torch.tensor(loc), fired[k * loc:(k + 1) * loc].sum()]))

    floor, onsets = tsh.fleet_statistics(gf[:loc], fired[:loc],
                                         None if n_dev == 1 else psum)
    assert np.float32(floor).view(np.int32) == want.view(np.int32)
    assert int(onsets) == int(out.global_onset_count)
    # A float32 division would not give JAX's bits at these batches.
    total = gf.sum() if n_dev == 1 else psum(gf[:1].sum().reshape(1))[0]
    assert np.float32(total / np.float32(batch)) != want
