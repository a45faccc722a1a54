"""Single-image and batch pipelines: image → classes → D field → system →
solver → Deff → the reference's CSVs."""
