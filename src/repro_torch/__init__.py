"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

The paper's experiment: HEFT and DADA schedule the tiled Cholesky, LU and
QR task graphs on the simulated CPU+GPU machine through the exact
event-driven engine, and the placement-scoring matrices are computed on
an NVIDIA GPU (the transfer fold in a hand-written CUDA kernel). The tile
factorizations then execute on the card in program order or in the order
a schedule gives, their GEMM-shaped updates in a second hand-written CUDA
kernel (``kernels/tile_gemm.py``). The model stack serves the dense GQA
transformers (chatglm3-6b, granite-8b, gemma-7b): ``launch/serve.py``
prefills and decodes with prefill attention and GQA decode in two more
hand-written CUDA kernels (``kernels/flash_attention.py``,
``kernels/flash_decode.py``). Module paths mirror ``repro``'s so each
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

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    cfg = get_config("chatglm3-6b")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))  # bf16, 12.5 GB
    tokens = torch.randint(0, cfg.vocab, (4, 64), device="cuda")
    logits = make_prefill_step(cfg)(params, {"tokens": tokens})  # (4, 1, vocab)
    nxt, cache = prefill_into_cache(params, cfg, tokens, 96)
    nxt, logits, cache = make_serve_step(cfg)(params, cache, nxt[:, None], 64)
"""
