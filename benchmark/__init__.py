"""The benchmark of the PyTorch and CUDA port of the structured-light
scanner: one command runs one cell (a rig deployment under one traffic mix)
for a fixed window and prints one JSON line. See ``run.py``."""
