"""Fields: the NeRF MLP and the σ-only proposal net."""
