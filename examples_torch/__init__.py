"""The PyTorch port's example drivers: counterparts of ``examples/``'s
self-contained scripts, under the same file names, on the port package."""
