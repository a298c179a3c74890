"""Chunked gated (decay) linear attention (B8) and its recompute
backward (B9)."""
