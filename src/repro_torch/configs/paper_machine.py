"""The paper's experimental platform (§4.1), as a MachineModel.

Two hexa-core Xeon X5650 @2.66 GHz (12 cores, ATLAS BLAS) + eight NVIDIA
Tesla C2050 (Fermi) GPUs on 4 PCIe switches (2 GPUs share a 16x link when
more than 4 GPUs are used). Each running GPU monopolizes one CPU core.

Rates are effective fp64 rates for PLASMA tile kernels, calibrated from the
public performance of those kernels on that hardware generation:
  * X5650 core: ~10.6 GFLOP/s peak fp64; ATLAS DGEMM ~85% -> ~9 GFLOP/s;
    panel/factorization kernels are less efficient.
  * C2050: 515 GFLOP/s peak fp64; MAGMA DGEMM ~60-65% -> ~300 GFLOP/s;
    memory-bound or panel kernels much lower, matching the strong
    kernel-dependent CPU/GPU speedup spread the paper's model captures.
PCIe 2.0 16x: ~8 GB/s asymptotic per switch.
"""
from __future__ import annotations

from repro_torch.core.machine import MachineModel, ResourceClass, make_machine

GF = 1e9

CPU_CLASS = ResourceClass(
    name="cpu",
    rates={
        # tile kernels (fp64, ATLAS on X5650, per core)
        "gemm": 9.0 * GF,
        "syrk": 8.5 * GF,
        "trsm": 8.0 * GF,
        "potrf": 5.5 * GF,
        "getrf": 4.5 * GF,
        "geqrt": 4.0 * GF,
        "tsqrt": 4.0 * GF,
        "ormqr": 7.0 * GF,
        "tsmqr": 7.5 * GF,
        "gessm": 7.5 * GF,
        "tstrf": 4.5 * GF,
        "ssssm": 8.0 * GF,
    },
    default_rate=7.0 * GF,
)

GPU_CLASS = ResourceClass(
    name="gpu",
    rates={
        # tile kernels (fp64, CUDA/MAGMA on C2050)
        "gemm": 300.0 * GF,
        "syrk": 250.0 * GF,
        "trsm": 160.0 * GF,
        "potrf": 30.0 * GF,  # small-panel factorizations are GPU-unfriendly
        "getrf": 25.0 * GF,
        "geqrt": 20.0 * GF,
        "tsqrt": 20.0 * GF,
        "ormqr": 140.0 * GF,
        "tsmqr": 150.0 * GF,
        "gessm": 150.0 * GF,
        "tstrf": 25.0 * GF,
        "ssssm": 200.0 * GF,
    },
    default_rate=120.0 * GF,
)

TOTAL_CORES = 12
PCIE_BANDWIDTH = 8e9  # bytes/s, asymptotic 16x
PCIE_LATENCY = 15e-6


def scaled_machine(
    n_gpus: int = 24,
    n_cpus: int = 8,
    gpus_per_switch: int = 2,
) -> MachineModel:
    """A beyond-paper platform: up to 32 heterogeneous resources.

    Same resource classes and PCIe model as the paper box, but with the
    counts the original hardware never had (the scheduler-scaling sweeps
    use 8 CPUs + 24 GPUs = 32 resources on NT=32/64 tile grids). GPUs do
    not pin compute cores here — ``n_cpus`` is the compute-CPU count — so
    the resource total is exactly ``n_cpus + n_gpus``.
    """
    n_res = n_cpus + n_gpus
    if not 0 < n_res <= 32:
        raise ValueError(f"scaled_machine supports 1..32 resources, got {n_res}")
    return make_machine(
        n_cpus=n_cpus,
        n_gpus=n_gpus,
        cpu_class=CPU_CLASS,
        gpu_class=GPU_CLASS,
        pcie_bandwidth=PCIE_BANDWIDTH,
        pcie_latency=PCIE_LATENCY,
        gpus_per_switch=gpus_per_switch,
        gpu_pins_cpu=False,
    )


def paper_machine(n_gpus: int, total_cores: int = TOTAL_CORES) -> MachineModel:
    """The paper machine with ``n_gpus`` GPUs enabled (0..8).

    With <=4 GPUs each GPU gets a dedicated switch; beyond that two GPUs
    share one switch's bandwidth (handled by make_machine's link groups).
    """
    if not 0 <= n_gpus <= 8:
        raise ValueError("the platform has at most 8 GPUs")
    return make_machine(
        n_cpus=total_cores,
        n_gpus=n_gpus,
        cpu_class=CPU_CLASS,
        gpu_class=GPU_CLASS,
        pcie_bandwidth=PCIE_BANDWIDTH,
        pcie_latency=PCIE_LATENCY,
        gpus_per_switch=2,
        gpu_pins_cpu=True,
    )
