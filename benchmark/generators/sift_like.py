"""SIFT-like rows: a clustered low-dimensional latent embedded by an
orthonormal frame, plus noise (``chip_smoke.py::make_sift_like``, drawn with
torch generators). ``generator_args``: ``latent_dim``, ``clusters``,
``center_scale``, ``noise``."""

from __future__ import annotations

import torch


def params(cfg: dict, gen: torch.Generator) -> dict:
    """The shared centres and frame, on the host (a few kilobytes)."""
    a = cfg["generator_args"]
    dz, d = a["latent_dim"], cfg["dim"]
    centers = torch.randn(a["clusters"], dz, generator=gen) * a["center_scale"]
    frame = torch.linalg.qr(torch.randn(d, dz, generator=gen, dtype=torch.float64))[0]
    return {"centers": centers, "frame": frame.T.to(torch.float32).contiguous()}


def rows(p: dict, cfg: dict, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` rows on the generator's device."""
    a = cfg["generator_args"]
    dev = gen.device
    centers, frame = p["centers"].to(dev), p["frame"].to(dev)
    ids = torch.randint(0, centers.shape[0], (n,), generator=gen, device=dev)
    z = centers[ids] + torch.randn(n, centers.shape[1], generator=gen, device=dev)
    noise = torch.randn(n, cfg["dim"], generator=gen, device=dev)
    return z @ frame + a["noise"] * noise
