"""Tiled dense linear algebra task graphs (Cholesky, LU, QR) and their
execution on torch tensors.

``cholesky_graph`` / ``lu_graph`` / ``qr_graph`` build the DAGs (with tile
bodies unless ``with_fns=False``); ``tiles.random_spd`` / ``random_dd`` /
``random_dense`` make the test matrices and ``tiles.split_tiles`` /
``join_tiles`` cut and join them; ``execute.execute_graph`` runs a DAG in
program order and ``execute.execute_schedule`` replays a simulated
schedule. The GEMM-shaped bodies run in the ``gemm_update`` CUDA kernel
on the card.
"""
