"""Gaussian blobs (``chip_smoke.py::make_data``, drawn with torch
generators): unit-variance noise around scaled gaussian centres.
``generator_args``: ``clusters``, ``center_scale``."""

from __future__ import annotations

import torch


def params(cfg: dict, gen: torch.Generator) -> dict:
    a = cfg["generator_args"]
    return {"centers": torch.randn(a["clusters"], cfg["dim"], generator=gen) * a["center_scale"]}


def rows(p: dict, cfg: dict, n: int, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    centers = p["centers"].to(dev)
    ids = torch.randint(0, centers.shape[0], (n,), generator=gen, device=dev)
    return centers[ids] + torch.randn(n, cfg["dim"], generator=gen, device=dev)
