"""Sparse engine: fixed-capacity site sets, slabs, span plans and convs."""
