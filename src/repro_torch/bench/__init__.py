"""The paper's experiment through the port: the fig1–fig4 sweeps on either
engine (``common.sweep``, rows; ``common.sweep_summaries``, unrounded), their strategy sets (``figures``) and the claim
checks C1–C7 (``paper_validation``; ``python -m
repro_torch.bench.paper_validation``)."""
