"""GloVe-like word vectors: rows from topics whose sizes follow a Zipf law
(frequent and rare words), a full-rank covariance with a decaying spectrum
(a random orthonormal frame times scales ``i ** -spectrum_exp`` over all
``dim`` dimensions, not a low-rank latent), a mean direction that every
row shares, and a log-normal norm factor a row (cosine ignores it; the
program still computes the norms). ``generator_args``: ``topics``,
``topic_zipf``, ``spectrum_exp``, ``center_scale``, ``noise``,
``mean_shift``, ``norm_sigma``."""

from __future__ import annotations

import torch


def params(cfg: dict, gen: torch.Generator) -> dict:
    """The shared basis, topic centres, mean and topic weights, on the host
    (a few hundred kilobytes)."""
    a = cfg["generator_args"]
    d = cfg["dim"]
    scales = torch.arange(1, d + 1, dtype=torch.float64) ** -a["spectrum_exp"]
    frame = torch.linalg.qr(torch.randn(d, d, generator=gen, dtype=torch.float64))[0]
    # a unit normal draw times basis has the covariance frame^T diag(scales^2) frame
    basis = scales[:, None] * frame
    centers = a["center_scale"] * torch.randn(a["topics"], d, generator=gen,
                                              dtype=torch.float64) @ basis
    u = torch.randn(d, generator=gen, dtype=torch.float64)
    # the mean's length is mean_shift times that of a typical draw, |scales|
    mean = a["mean_shift"] * torch.linalg.vector_norm(scales) * u / torch.linalg.vector_norm(u)
    weights = torch.arange(1, a["topics"] + 1, dtype=torch.float64) ** -a["topic_zipf"]
    return {"basis": basis.to(torch.float32), "centers": (centers + mean).to(torch.float32),
            "weights": (weights / weights.sum()).to(torch.float32)}


def rows(p: dict, cfg: dict, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` rows on the generator's device."""
    a = cfg["generator_args"]
    dev = gen.device
    basis, centers = p["basis"].to(dev), p["centers"].to(dev)
    topic = torch.multinomial(p["weights"].to(dev), n, replacement=True, generator=gen)
    z = torch.randn(n, cfg["dim"], generator=gen, device=dev) @ basis
    scale = torch.exp(a["norm_sigma"] * torch.randn(n, 1, generator=gen, device=dev))
    return (centers[topic] + a["noise"] * z) * scale
