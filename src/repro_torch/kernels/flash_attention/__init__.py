"""Causal GQA flash attention (prefill)."""
