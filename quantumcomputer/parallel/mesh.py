"""Device mesh + sharding policy for the distributed state vector.

The 2^n amplitude vector is sharded over its *leading global index bits*:
with D = 2^d devices on a 1D mesh axis 'q', device k holds the contiguous
index range [k * 2^(n-d), (k+1) * 2^(n-d)) — equivalently, the top d qubits
[n-d, n) are "global" (their bit value selects the device), the rest are
shard-local.  This is the quantum-simulator analog of tensor/sequence
parallelism (SURVEY.md §2): gates on local qubits run shard-local; gates on
global qubits exchange whole shards over the interconnect via
collective_permute.

The reference has no distributed story (single-threaded by design,
Report §IV.D); this module is a pure build deliverable.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "q"


def comm_domain(dev) -> int:
    """Communication domain of a device: devices in the same domain share
    the fast intra-host interconnect (ICI below); crossing domains rides
    the slower inter-host network (DCN below).

    Devices group by process_index (one process per host): distributed
    CPU devices expose a uniform slice_index, so honoring it would
    collapse every process into one "domain" and silently disable the
    ordering policy (scripts/dcn_dryrun.py).  Devices with no platform
    attribute (synthetic test doubles) group by slice_index."""
    if getattr(dev, "platform", None) is None:
        v = getattr(dev, "slice_index", None)
        if v is not None:
            return int(v)
    v = getattr(dev, "process_index", None)
    return int(v) if v is not None else 0


def order_devices_for_ici(devices: Sequence) -> list:
    """Order devices so ICI neighbors occupy the LOW mesh-index bits.

    The sharded engine's collectives are ppermute exchanges at offset 2^p
    for global-qubit bit p (parallel/sharded.py).  Grouping each comm
    domain (slice/host) contiguously puts the bits below
    log2(devices_per_domain) entirely intra-domain, so those butterflies
    ride ICI; only the top mesh bits — the RAREST exchanges for circuits
    that keep hot qubits low — cross the DCN (SURVEY.md §5, distributed
    communication backend)."""
    return sorted(devices, key=lambda dv: (comm_domain(dv), getattr(dv, "id", 0)))


def _pick_subset(devices: list, target: int) -> list:
    """Choose `target` (a power of two) devices from the domain-ordered
    list maximizing ICI block purity: take 2^b devices from each of
    target/2^b domains with the LARGEST b that covers the target, so
    2^b-aligned blocks stay domain-pure (ici_degree >= b).  A plain
    sorted-prefix can straddle a domain boundary mid-block — e.g. 8 of 12
    devices in 6+6 domains: the prefix gives 6+2 (degree 0), while 4+4
    gives degree 2."""
    by_dom: dict = {}
    for dv in devices:  # already domain-ordered
        by_dom.setdefault(comm_domain(dv), []).append(dv)
    sizes = sorted((len(v) for v in by_dom.values()), reverse=True)
    b = target.bit_length() - 1
    while b >= 0:
        blk = 1 << b
        n_blocks = target // blk
        if sum(1 for s in sizes if s >= blk) >= n_blocks:
            picked: List = []
            for dom_devs in sorted(by_dom.values(), key=len, reverse=True):
                if len(picked) >= target:
                    break
                if len(dom_devs) >= blk:
                    picked.extend(dom_devs[:blk])
            return picked[:target]
        b -= 1
    return devices[:target]  # unreachable: b=0 always covers


def build_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1D mesh over 2^d devices (state sharding needs a power of two),
    ordered so intra-slice (ICI) neighbors take the low mesh bits and DCN
    crossings only occur on the high bits.

    An explicitly requested non-power-of-two device count is an error (a
    silently truncated mesh would surprise `--devices 6` users); with no
    explicit request, the largest power of two that fits the available
    devices is used.  Subset selection happens AFTER the ICI ordering and
    prefers domain-aligned blocks (see _pick_subset) — truncating the raw
    jax.devices() list first could straddle comm domains even when an
    all-ICI subset exists."""
    explicit = num_devices is not None or devices is not None
    if devices is not None and num_devices is not None and len(devices) != num_devices:
        raise ValueError(
            f"num_devices={num_devices} conflicts with len(devices)={len(devices)}; "
            "pass one or make them agree"
        )
    target = num_devices
    if devices is None:
        devices = jax.devices()
        if target is not None and target > len(devices):
            raise ValueError(f"requested {target} devices, only {len(devices)} available")
    devices = order_devices_for_ici(devices)
    if target is None:
        target = len(devices)
        if explicit:  # explicit devices= list: its length must be exact
            d = target.bit_length() - 1
            if target != 1 << d:
                raise ValueError(
                    f"state sharding needs a power-of-two device count, got {target}"
                )
    d = target.bit_length() - 1
    if target != 1 << d:
        if explicit:
            raise ValueError(
                f"state sharding needs a power-of-two device count, got {target}"
            )
        target = 1 << d
    if target < len(devices):
        devices = order_devices_for_ici(_pick_subset(devices, target))
    return Mesh(np.array(devices), (AXIS,))


def ici_degree(mesh: Mesh) -> int:
    """Number of LOW global-qubit bits whose exchanges stay intra-domain
    (ICI) under this mesh's device order; bits >= this cross DCN.

    Computed directly as the largest b with every 2^b-aligned block
    domain-pure — correct for UNEQUAL domain sizes too (a per-domain
    average would under-report, e.g. [A,A,B,B,B,B,B,B] has degree 1)."""
    devs = list(mesh.devices.ravel())
    domains = [comm_domain(dv) for dv in devs]
    if len(set(domains)) <= 1:
        return mesh_degree(mesh)
    b = 0
    while (1 << (b + 1)) <= len(devs):
        size = 1 << (b + 1)
        if any(
            len(set(domains[s : s + size])) > 1 for s in range(0, len(devs), size)
        ):
            break
        b += 1
    return b


def mesh_degree(mesh: Mesh) -> int:
    """log2(number of devices) = number of global qubits."""
    D = mesh.shape[AXIS]
    d = D.bit_length() - 1
    assert D == 1 << d, f"mesh size {D} must be a power of two"
    return d


def state_sharding(mesh: Mesh) -> NamedSharding:
    """Planar (2, 2^n) state: shard the amplitude axis, replicate planes."""
    return NamedSharding(mesh, P(None, AXIS))
