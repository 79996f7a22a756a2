"""Device search serving: a columnar index over ``file_path`` rows, mirrored
on the card and scored by the CUDA kernels of ``csrc/search.cu``, refreshed
incrementally at the commit watermark, with SQLite as the oracle."""
