"""The sharded mesh's placement: which device each shard runs on.

The workload has one parallel dimension, the MSM term axis, so a mesh of D
shards is a tuple of D `torch.device`s: shard k takes the k-th slice of the
term axis and runs on the k-th device.  There is no process group and no
collective library: one process drives every shard (PERF.md says why), and
the per-shard window sums are copied to the first device of the placement
and folded there.

A placement may repeat a device.  That is the VIRTUAL mesh: D shards on one
card (how `chip_smoke.py` runs a mesh on a one-card machine) or on the CPU
(how the tests run it), the counterpart of the JAX package's virtual host
devices.  `shard_chips` names the chip behind each shard.
"""

import torch


def batch_mesh(n_devices: "int | None" = None, devices=None,
               device_ids=None) -> "tuple[torch.device, ...]":
    """The placement of a 1-D mesh, shard k first:

    * `devices` given: exactly those devices, repeats allowed (a virtual
      mesh); `n_devices`, when given too, must equal their count;
    * `device_ids` given: `cuda:device_ids[k]` for shard k (a reformed
      mesh on the surviving cards); `n_devices`, when given, must match;
    * otherwise `cuda:0` .. `cuda:n_devices−1`, all visible cards by
      default.

    Raises ValueError for a count that does not match, or for more cards
    or an index beyond those visible."""
    if devices is not None:
        placement = tuple(torch.device(d) for d in devices)
        if n_devices is not None and int(n_devices) != len(placement):
            raise ValueError(f"n_devices={n_devices} but {len(placement)} "
                             f"devices")
        return placement
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_ids is not None:
        ids = tuple(int(i) for i in device_ids)
        if n_devices is not None and int(n_devices) != len(ids):
            raise ValueError(f"n_devices={n_devices} but {len(ids)} "
                             f"device ids")
        if any(i < 0 or i >= visible for i in ids):
            raise ValueError(f"device ids {ids!r} out of range for "
                             f"{visible} CUDA devices")
        return tuple(torch.device("cuda", i) for i in ids)
    n = visible if n_devices is None else int(n_devices)
    if n > visible:
        raise ValueError(f"requested {n} CUDA devices, have {visible}")
    return tuple(torch.device("cuda", i) for i in range(n))


def shard_chips(placement, device_ids=None) -> "tuple[int, ...]":
    """The chip id of each shard of `placement`, the ids the ChipRegistry
    keeps: `device_ids[k]` when the caller names the chips (on cards the
    reformed mesh's CUDA indices; on a virtual mesh the logical chips of
    `verify_many(device_ids=)`), else a card's CUDA index (every shard of
    a virtual mesh on one card names that card, so a fault there never
    excludes another card) and on the CPU the shard position k — the
    counterpart of the JAX package's virtual host devices."""
    if device_ids:
        return tuple(int(c) for c in device_ids)
    out = []
    for k, d in enumerate(placement):
        d = torch.device(d)
        if d.type == "cuda":
            out.append(torch.cuda.current_device() if d.index is None
                       else d.index)
        else:
            out.append(k)
    return tuple(out)
