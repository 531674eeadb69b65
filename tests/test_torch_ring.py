"""Port parity: the mesh ring hop (K4) and the ring allreduce.

On one card the mesh is a leading ``[R, S]`` block axis, and a ring hop
moves each block to its ring successor along one axis. The plain
version (``ring_hop_plain``, to which ``models.kernels.ring_hop``
dispatches on CPU tensors) must equal ``jax.lax.ppermute`` with ``perm = [(i, i + 1)]``
inside a ``shard_map`` over the reference's ``make_mesh(2, 4)`` on the 8
virtual CPU devices, which is the parity oracle of the reference's
``pallas_right_permute``. The port's ``_ring_allreduce`` (shard ring,
then replica ring) must equal the reference's under the same
``shard_map``. Inputs come from seeded numpy. Tolerance: exact equality
(int32).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bifromq_tpu.parallel import sharded as js
from bifromq_tpu_torch.models import kernels as tk
from bifromq_tpu_torch.parallel import sharded as ts

AXES = ((js.REPLICA_AXIS, 0), (js.SHARD_AXIS, 1))


@functools.lru_cache(maxsize=None)
def _mesh():
    return js.make_mesh(2, 4)


def _blockwise(fn):
    """``fn`` on each [1, 1, n] block of an [R, S, n] array, one device
    per block of the 2x4 mesh."""
    spec = P(js.REPLICA_AXIS, js.SHARD_AXIS)
    return jax.jit(js._shard_map(fn, mesh=_mesh(), in_specs=(spec,),
                                 out_specs=spec, check_vma=False))


def _x(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 30), 1 << 30, size=(2, 4, n),
                        dtype=np.int32)


@pytest.mark.parametrize("n", (1, 2, 10, 1000))
@pytest.mark.parametrize("axis_name,axis", AXES)
def test_ring_hop_plain_equals_ppermute(axis_name, axis, n):
    x = _x(n, seed=n + axis)
    size = x.shape[axis]
    perm = [(i, (i + 1) % size) for i in range(size)]
    want = np.asarray(_blockwise(
        lambda b: jax.lax.ppermute(b, axis_name, perm))(x))
    got = tk.ring_hop(torch.from_numpy(x), axis)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", (2, 10))
def test_ring_allreduce_equals_reference(n):
    """Shard ring, then replica ring, as the mesh expand step merges its
    per-peer counts; every slot ends with the grid's column sum."""
    x = _x(n, seed=100 + n) >> 8   # no int32 wrap in the 8-block sum
    names = (js.REPLICA_AXIS, js.SHARD_AXIS)

    def ref_fn(b):
        t = js._ring_allreduce(b, js.SHARD_AXIS, 4, names)
        return js._ring_allreduce(t, js.REPLICA_AXIS, 2, names)
    want = np.asarray(_blockwise(ref_fn)(x))
    t = ts._ring_allreduce(torch.from_numpy(x), ts.SHARD_AXIS, 4)
    got = ts._ring_allreduce(t, ts.REPLICA_AXIS, 2).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[1, 3], x.sum(axis=(0, 1)))


def test_ring_allreduce_of_one_slot_is_the_input():
    x = torch.from_numpy(_x(3, seed=7)[:1, :1])
    assert ts._ring_allreduce(x, ts.SHARD_AXIS, 1) is x


def test_ring_hop_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tk.ring_hop(torch.zeros(2, 4, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        tk.ring_hop(torch.zeros(2, 4, 3, dtype=torch.int32), 2)
