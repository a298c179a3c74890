"""Chunked causal linear attention (B2) and its §3.3 backward (B3)."""
