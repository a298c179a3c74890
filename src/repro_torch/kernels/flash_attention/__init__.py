"""Causal flash-attention forward (B10), the softmax baseline's prefill."""
