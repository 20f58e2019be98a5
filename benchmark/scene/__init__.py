"""Inputs of the benchmark: the rig, the scene and the Gray-code frames a
camera captures, rendered from the seed (``render.py`` on the card,
``frozen_numpy.py`` the host copy it is held to)."""
