"""Tiled dense linear algebra task graphs (Cholesky, LU, QR)."""
