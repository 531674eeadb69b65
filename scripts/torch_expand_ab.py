#!/usr/bin/env python3
"""Time the mesh's expansion stage of one checkout of the port on one card.

Usage: ``python3 scripts/torch_expand_ab.py ROOT`` on a machine with a
CUDA card, where ROOT is a checkout of this repository (the working tree,
or an older commit unpacked with ``git archive``). The script imports
``bifromq_tpu_torch`` from ROOT, builds its kernels, and times on seeded
``[R, S, b, A] = [2, 4, 1024, 32]`` interval grids (``cap`` = 65,536 pairs
a block, the config-5 mesh's shapes; two blocks overrun the buffer, as
the heavy tenant's shard does):

- ``per_block_ms``: the expansion wrapper called once per block, 8 calls;
- ``batched_ms``: one call for all 8 blocks (``null`` where the checkout's
  ``kernel_expand`` takes no leading block axis);
- ``mesh_expand_ms``: ``parallel.sharded.mesh_expand`` whole (expansion,
  bucket offsets and the ring merge), n_peers = 0;

each as the whole call (CUDA events over back-to-back calls) and as the
device time of its launches alone (``*_device_ms``, a sleep kernel holds
the stream while the host enqueues). It checks that every variant gives
the same pairs, and prints one JSON line with the card's name and power
limit. To compare two checkouts, run it for each in one command, in the
order A, B, B, A.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 4)
B, A, CAP_LANES = 1024, 32, 64


def grids(np):
    """Seeded config-5-shaped interval grids: six light blocks and the
    heavy shard's two (one per replica) far past the buffer."""
    rng = np.random.default_rng(5)
    r, s = MESH
    starts = rng.integers(0, 1 << 21, (r, s, B, A)).astype(np.int32)
    counts = rng.integers(1, 30, (r, s, B, A)).astype(np.int32)
    counts[rng.random(counts.shape) < 0.85] = 0
    heavy = rng.integers(1, 400, (r, B, A)).astype(np.int32)
    heavy[rng.random(heavy.shape) < 0.3] = 0
    counts[:, 0] = heavy
    return starts, counts


def main() -> int:
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_expand_ab: no CUDA device", file=sys.stderr)
        return 1
    # the timing helpers come from this checkout, the package from ROOT
    sys.path.insert(0, HERE)
    from chip_smoke import max_abs_err, smi_line, time_device_ms, time_ms
    sys.path.insert(0, root)
    from bifromq_tpu_torch.models import kernels as K
    from bifromq_tpu_torch.ops.match import RouteIntervals
    from bifromq_tpu_torch.parallel.sharded import mesh_expand
    from bifromq_tpu_torch.utils import device as D
    D.build_all()

    dev = torch.device("cuda")
    r, s = MESH
    g, cap = r * s, B * CAP_LANES
    st, c = (torch.from_numpy(x).to(dev) for x in grids(np))
    ivl = RouteIntervals(start=st, count=c,
                         n_routes=c.clamp(min=0).sum(-1, dtype=torch.int32),
                         overflow=torch.zeros((r, s, B), dtype=torch.bool,
                                              device=dev))
    blocks_s, blocks_c = st.reshape(g, B, A), c.reshape(g, B, A)
    views = [(blocks_s[i], blocks_c[i]) for i in range(g)]
    slot_peer = torch.zeros((s, 1), dtype=torch.int32, device=dev)

    def per_block():
        return [K.kernel_expand(vs, vc, cap=cap) for vs, vc in views]

    def batched():
        return K.kernel_expand(blocks_s, blocks_c, cap=cap)

    def whole():
        return mesh_expand(ivl, slot_peer, cap=cap, n_peers=0)

    ref = [torch.stack(x) for x in zip(*per_block())]
    try:
        got = batched()
    except ValueError:
        got = None
    mesh = whole()
    torch.cuda.synchronize()
    err = max_abs_err(torch, [mesh.slots.reshape(g, cap),
                              mesh.rows.reshape(g, cap)], ref[:2])
    if got is not None:
        err = max(err, max_abs_err(torch, got, ref))
    if err:
        print(f"torch_expand_ab: variants differ by {err}", file=sys.stderr)
        return 1
    out = {"root": os.path.relpath(root, HERE), "card": smi_line(),
           "grid": [r, s, B, A], "cap": cap,
           "n_pairs": ref[3].tolist()}
    for name, fn in (("per_block", per_block), ("batched", batched),
                     ("mesh_expand", whole)):
        if name == "batched" and got is None:
            out["batched_ms"] = out["batched_device_ms"] = None
            continue
        out[f"{name}_ms"] = time_ms(torch, fn, 50)
        out[f"{name}_device_ms"] = time_device_ms(torch, fn, 50)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
