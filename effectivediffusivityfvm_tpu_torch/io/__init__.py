"""Image decoding and the reference's CSV writers (numpy, host side)."""
