"""Serving: prefill and single-token decode steps."""
