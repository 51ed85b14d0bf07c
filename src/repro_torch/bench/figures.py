"""The paper's four figures: each one's kernel and strategy set, the
counterparts of the reference's ``benchmarks/fig1_alpha_sweep.py`` …
``fig4_qr.py``.

* Fig. 1: the affinity control parameter α on Cholesky (DPOTRF), with and
  without communication prediction.
* Fig. 2: Cholesky, HEFT vs DADA(0) vs DADA(a) vs DADA(a)+CP, plus the
  work-stealing baseline discussed in §4.3.
* Fig. 3: LU (DGETRF), where DADA(a)+CP moves much less data than HEFT.
* Fig. 4: QR (DGEQRF), where HEFT outperforms every dual approximation.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .common import STRATEGIES

ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)


def fig1_strategies() -> Dict[str, str]:
    """Label -> registry spec: DADA(α) without, then with, communication
    prediction."""
    strategies = {f"dada({a:g})": f"dada?alpha={a:g}" for a in ALPHAS}
    for a in ALPHAS:
        strategies[f"dada({a:g})+cp"] = f"dada?alpha={a:g}&use_cp=1"
    return strategies


# figure name -> (kernel, strategy set), in the paper's order
FIGURES: Dict[str, Tuple[str, Dict[str, str]]] = {
    "fig1_alpha_sweep": ("cholesky", fig1_strategies()),
    "fig2_cholesky": ("cholesky", STRATEGIES),
    "fig3_lu": ("lu", STRATEGIES),
    "fig4_qr": ("qr", STRATEGIES),
}
