"""A one-process device mesh: the port's counterpart of ``jax.sharding``.

JAX's mesh is single-controller: one process drives every device, and a
``jax.sharding.Mesh`` is an array of devices. Here a :class:`Mesh` is a
tuple of ``torch.device`` *slots* over one axis. A slot may name a device
that another slot names too: eight slots over ``cpu`` are the counterpart
of the eight virtual CPU devices the reference's tests run on, and slots
over ``cuda:0`` split one card's work the way a mesh of that size would.

A sharded axis is split into ``mesh.size`` contiguous, equal blocks in slot
order, block ``s`` computed on ``mesh.devices[s]``. Replicated inputs are
placed once per distinct device (``Tensor.to`` returns the tensor itself on
its own device, so slots sharing a device share it). Results are combined
on ``mesh.devices[0]`` in slot order: concatenated, summed partial by
partial, or picked lexicographically. Nothing here is chosen at run time,
so a fixed mesh gives the same bits on every run.

This module imports nothing else of the package, so every module that
takes a sharding can import it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import torch


def _resolve(device) -> torch.device:
    """A slot's device, with the index made explicit; raises if the device
    is not there (a mesh never moves a slot's work elsewhere)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        index = dev.index if dev.index is not None else (torch.cuda.current_device() if count else 0)
        if index >= count:
            raise RuntimeError(f"mesh slot {device!s}: this process sees {count} CUDA device(s)")
        dev = torch.device("cuda", index)
    return dev


class Mesh:
    """A one-axis mesh of device slots, as ``jax.sharding.Mesh(devices,
    axis_names)``: ``.devices``, ``.axis_names``, ``.size``."""

    def __init__(self, devices: Iterable, axis_names: Sequence[str] | str = ("data",)) -> None:
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        if len(names) != 1:
            raise ValueError(f"the port's mesh has one axis, got {names}")
        slots = tuple(_resolve(d) for d in devices)
        if not slots:
            raise ValueError("a mesh needs at least one device slot")
        self.devices: Tuple[torch.device, ...] = slots
        self.axis_names: Tuple[str, ...] = names

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


@dataclass(frozen=True)
class NamedSharding:
    """An axis split over the mesh axis ``axis`` (the reference's
    ``NamedSharding(mesh, P(axis))``); a parameter that takes one takes
    None for unsharded."""

    mesh: Mesh
    axis: str

    def __post_init__(self):
        if self.axis not in self.mesh.axis_names:
            raise ValueError(f"axis {self.axis!r} is not an axis of {self.mesh}")


def blocks(n: int, size: int, what: str = "axis") -> List[Tuple[int, int]]:
    """``size`` contiguous, equal ``(start, stop)`` blocks of ``range(n)``."""
    if n % size:
        raise ValueError(f"{what} ({n}) must divide by mesh size {size}")
    b = n // size
    return [(s * b, (s + 1) * b) for s in range(size)]


def add_in_order(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Sum per-slot partials on ``device``, in slot order; one part is
    returned as it is."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def concat(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """Concatenate per-slot results on ``device`` in slot order."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)
