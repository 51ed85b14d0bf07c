"""Machine model: heterogeneous resources, memory spaces, links.

The paper's platform abstraction (counterpart of ``repro.core.machine``):
  * ``m`` homogeneous CPUs sharing host memory (no transfer among them),
  * ``k`` homogeneous GPUs, each with a private memory, attached to the host
    through PCIe switches; two GPUs on one switch share the 16x bandwidth,
  * each *running* GPU monopolizes one CPU core to manage its worker
    (paper §4.1), so ``k`` GPUs leave ``total_cores - k`` compute CPUs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

HOST_MEM = -1  # memory-space id of host memory


@dataclass(frozen=True)
class ResourceClass:
    """A class of homogeneous processors with per-task-kind rates.

    ``rates`` maps task kind -> effective FLOP/s for that kind on this class.
    ``default_rate`` is used for unknown kinds.
    """

    name: str
    rates: Dict[str, float]
    default_rate: float

    def rate(self, kind: str) -> float:
        return self.rates.get(kind, self.default_rate)


@dataclass(frozen=True)
class Resource:
    """One worker: a CPU core or a GPU (with its manager core)."""

    rid: int
    cls: ResourceClass
    mem: int  # memory space id: HOST_MEM for CPUs, >=0 for GPU memories
    link: Optional[int] = None  # PCIe switch group id (None: none)

    @property
    def is_accelerator(self) -> bool:
        return self.mem != HOST_MEM

    def __repr__(self) -> str:
        return f"{self.cls.name}{self.rid}"


@dataclass
class LinkModel:
    """Asymptotic-bandwidth + latency transfer model (StarPU-like).

    ``bandwidth`` is per *switch group* (bytes/s); GPUs sharing a switch
    share it. ``latency`` is the fixed per-transfer cost.
    """

    bandwidth: float
    latency: float = 1e-5


@dataclass
class MachineModel:
    resources: List[Resource]
    link: LinkModel

    def __post_init__(self) -> None:
        # cached partitions (resources never change after construction)
        self._cpus = [r for r in self.resources if not r.is_accelerator]
        self._gpus = [r for r in self.resources if r.is_accelerator]

    @property
    def cpus(self) -> List[Resource]:
        return self._cpus

    @property
    def gpus(self) -> List[Resource]:
        return self._gpus


def make_machine(
    n_cpus: int,
    n_gpus: int,
    cpu_class: ResourceClass,
    gpu_class: ResourceClass,
    pcie_bandwidth: float = 8e9,
    pcie_latency: float = 1e-5,
    gpus_per_switch: int = 2,
    gpu_pins_cpu: bool = True,
) -> MachineModel:
    """Build the paper-style machine.

    ``n_cpus`` is the number of *cores in the box*; if ``gpu_pins_cpu`` each
    GPU removes one compute core (paper: "Each running GPU monopolizes a CPU
    to manage its worker").
    """
    compute_cpus = n_cpus - n_gpus if gpu_pins_cpu else n_cpus
    if compute_cpus < 0:
        raise ValueError("more GPUs than cores to pin")
    resources: List[Resource] = []
    rid = 0
    for _ in range(compute_cpus):
        resources.append(Resource(rid, cpu_class, HOST_MEM, None))
        rid += 1
    for g in range(n_gpus):
        # Up to 4 switches; with <=4 GPUs each gets its own switch (paper:
        # "Experiments using up to 4 GPUs avoid this bandwidth constraint").
        switch = g % 4 if n_gpus <= 4 else g // gpus_per_switch
        resources.append(Resource(rid, gpu_class, mem=g, link=switch))
        rid += 1
    return MachineModel(
        resources=resources,
        link=LinkModel(bandwidth=pcie_bandwidth, latency=pcie_latency),
    )
