"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

The paper's experiment: HEFT and DADA schedule the tiled Cholesky, LU and
QR task graphs on the simulated CPU+GPU machine through the exact
event-driven engine, and the placement-scoring matrices are computed on
an NVIDIA GPU (the transfer fold in a hand-written CUDA kernel). Module
paths mirror ``repro``'s so each counterpart is easy to find; this
package imports neither ``jax`` nor ``repro``.

Entry points run on the card unless the caller passes ``device="cpu"``::

    from repro_torch.core import run_simulation
    from repro_torch.sched import resolve
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.configs.paper_machine import paper_machine

    res = run_simulation(cholesky_graph(16), paper_machine(8),
                         resolve("dada?alpha=0.5&use_cp=1"), seed=0)
"""
