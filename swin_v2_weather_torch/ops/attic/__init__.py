"""Retired A/B schedules of the qkv-fused window attention (K12: v4 and v5),
selectable as in the JAX package (``QKV_IMPL``)."""
