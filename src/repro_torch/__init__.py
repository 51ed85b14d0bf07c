"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

The paper's experiment: HEFT and DADA schedule the tiled Cholesky, LU and
QR task graphs on the simulated CPU+GPU machine through the exact
event-driven engine, and the placement-scoring matrices are computed on
an NVIDIA GPU (the transfer fold in a hand-written CUDA kernel). The tile
factorizations then execute on the card in program order or in the order
a schedule gives, their GEMM-shaped updates in a second hand-written CUDA
kernel (``kernels/tile_gemm.py``). Module paths mirror ``repro``'s so each
counterpart is easy to find; this package imports neither ``jax`` nor
``repro``.

Entry points run on the card unless the caller passes ``device="cpu"``::

    from repro_torch.core import run_simulation
    from repro_torch.sched import resolve
    from repro_torch.linalg import tiles
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.execute import execute_schedule
    from repro_torch.configs.paper_machine import paper_machine

    res = run_simulation(cholesky_graph(16), paper_machine(8),
                         resolve("dada?alpha=0.5&use_cp=1"), seed=0)
    a = tiles.random_spd(16 * 512)  # f32, on the card
    store = execute_schedule(cholesky_graph(16), tiles.split_tiles(a, 512), res)
    low = tiles.join_tiles(store, 16, 512).tril()
"""
