"""What the example twins share: the device choice, a fence for host
timing and the image writer."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device


def pick_device(cpu: bool) -> torch.device:
    """The CPU with ``--cpu``, else the card (raises where there is none)."""
    return resolve_device("cpu" if cpu else None)


def sync(dev: torch.device) -> None:
    """Waits for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device):
    """``(fn(), seconds)``: host time of one call, up to the device's end."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def write_pnm(path: str, img8: np.ndarray) -> None:
    """Writes a uint8 image as binary PGM ([h, w], P5) or PPM ([h, w, 3],
    P6)."""
    magic = "P6" if img8.ndim == 3 else "P5"
    h, w = img8.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"{magic}\n{w} {h}\n255\n".encode())
        fh.write(np.ascontiguousarray(img8, dtype=np.uint8).tobytes())
