"""The one option every computing tool of the port adds to the JAX tool's."""

from __future__ import annotations

import argparse


def add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "plain PyTorch path on the host). Without a card, "
                        "cuda raises")
