"""Scripts that drive libviso_torch on the card, and their helpers."""
