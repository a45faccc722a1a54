"""Image → phase classes → diffusivity field (numpy)."""
