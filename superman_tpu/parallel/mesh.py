"""Device mesh construction and (multi-host) runtime initialization.

The engine's replacement for the reference's device handling (OpenMP thread
per GPU + cudaSetDevice, gpu_exact_dense.cu:729-755): a 1-D
`jax.sharding.Mesh` over all addressable chips; multi-host slices join via
`jax.distributed.initialize` and the same code path shards over the global
mesh (collectives ride ICI within a slice, DCN across).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

RANGE_AXIS = "ranges"   # the single mesh axis: Gray-code range shards


def init_distributed() -> None:
    """Initialize the multi-host runtime if a coordinator is configured
    (no-op single-host).  Call once at program start on each host."""
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()


def make_mesh(num_devices: Optional[int] = None,
              devices=None) -> Mesh:
    """1-D mesh over `num_devices` (default: all) devices."""
    devs = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        if len(devs) < num_devices:
            raise RuntimeError(
                f"requested a {num_devices}-device mesh but only "
                f"{len(devs)} devices are visible (for CPU testing set "
                f"XLA_FLAGS=--xla_force_host_platform_device_count=N)")
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (RANGE_AXIS,))


def mesh_for_flags(flags) -> Optional[Mesh]:
    """None (single device) unless the flags ask for a multi-device run.

    Multi-device ids come from the ONE id table (core/flags.py:
    id_behavior), so the CLI and the API agree on which ids get a mesh."""
    n_avail = len(jax.devices())
    if flags.mesh_shape is not None:
        want = int(np.prod(flags.mesh_shape))
        return make_mesh(min(want, n_avail)) if want > 1 else None
    from ..core.flags import id_behavior
    try:
        multi = id_behavior(flags.perman_algo, flags.sparse,
                            flags.approximation)["multi"]
    except ValueError:
        multi = False     # unknown ids are rejected by the dispatcher
    if multi and n_avail > 1:
        return make_mesh(min(flags.gpu_num, n_avail) if flags.gpu_num > 0
                         else n_avail)
    return None
