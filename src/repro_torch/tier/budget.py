"""Memory-budget accounting for the tiered corpus: the bytes resident on
the device against those parked in host memory, by component (engine
``stats()`` reports it)."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Bytes resident per component, split by residence."""

    device: Dict[str, int]
    host: Dict[str, int]

    @property
    def device_total(self) -> int:
        return int(sum(self.device.values()))

    @property
    def host_total(self) -> int:
        return int(sum(self.host.values()))

    def as_dict(self) -> dict:
        return {"device": dict(self.device), "host": dict(self.host),
                "device_total": self.device_total, "host_total": self.host_total}
