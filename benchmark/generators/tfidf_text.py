"""TF-IDF rows of a newsgroup corpus, shaped like ``TfidfTransformer()``
over scikit-learn's ``fetch_20newsgroups_vectorized``: scipy CSR float32,
indices sorted, no duplicate entries, no empty rows, no two rows alike,
each row of unit L2 norm.

A document is a post of one of ``groups`` newsgroups, drawn uniformly. It
holds a number of distinct terms drawn log-normal (``length_median``,
``length_sigma``), at least ``min_terms`` (the headers) and at most
``max_terms``. Its terms are drawn without replacement (the Gumbel top-k)
from weights in two parts: a share ``group_share`` on a Zipf over its
newsgroup's own ``group_vocab`` terms (exponent ``group_zipf``) and the
remainder on a Zipf background over the whole vocabulary (exponent
``zipf``, ranks shuffled over the feature ids), which every document
shares. The shared background is what keeps cosine distances spread: over
disjoint supports they concentrate so tightly that diversify prunes the
search graph to degree about 1.6 (``bench.py::make_tfidf_data``). A term's
count is ``1 + Poisson(tf_poisson)``; its value ``count * idf``, with
``TfidfTransformer``'s smooth idf ``ln((1 + n) / (1 + df)) + 1`` over the
configuration's ``rows`` and the document frequencies that these weights
give (``params``), the same for rows and queries; rows are then scaled to
unit norm, as ``TfidfTransformer`` scales them.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import sparse

# the document frequencies average over lengths at these many normal
# quantiles, evenly spaced over -4 to 4 standard deviations
_DF_LENGTHS = 24
# elements of the Gumbel keys drawn at once
_BLOCK_ELEMS = 1 << 26


class Corpus(sparse.csr_matrix):
    """A CSR matrix whose ``len()`` is its row count, as a dense array's is:
    the harness's loops count the pool's rows with ``len``. Row selections
    keep the class."""

    def __len__(self):
        return self.shape[0]


def _zipf(n: int, s: float) -> torch.Tensor:
    w = torch.arange(1, n + 1, dtype=torch.float64) ** -s
    return w / w.sum()


def _lengths(a: dict, z: torch.Tensor) -> torch.Tensor:
    """Distinct terms a document from standard normal draws ``z``."""
    n = torch.round(a["length_median"] * torch.exp(a["length_sigma"] * z.to(torch.float64)))
    return n.clamp(a["min_terms"], a["max_terms"]).to(torch.int64)


def _inclusion(w: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The chance that each term is among a document's ``L`` distinct terms
    drawn without replacement from weights ``w`` [G, V], for each ``L`` of
    ``lengths`` [Q]: ``1 - exp(-t w)`` with ``t`` such that the chances sum
    to ``L`` (the Poisson approximation), found by Newton's method from
    below (the sum is concave in ``t``). Returns [G, Q, V]."""
    want = lengths.to(torch.float64)[None, :, None]
    t = want.expand(w.shape[0], -1, 1).clone()
    w = w[:, None, :]
    for _ in range(100):
        e = torch.exp(-t * w)
        f = (1.0 - e).sum(-1, keepdim=True) - want
        if float((f / want).abs().max()) < 1e-9:
            break
        t = t - f / (w * e).sum(-1, keepdim=True)
    return 1.0 - e


def params(cfg: dict, gen: torch.Generator) -> dict:
    """On the host: the newsgroups' weights [G, V] and the idf [V], both
    float32."""
    a = cfg["generator_args"]
    v, g = cfg["dim"], a["groups"]
    background = torch.empty(v, dtype=torch.float64)
    background[torch.randperm(v, generator=gen)] = _zipf(v, a["zipf"])
    vocab = torch.stack([torch.randperm(v, generator=gen)[:a["group_vocab"]] for _ in range(g)])
    own = torch.zeros(g, v, dtype=torch.float64)
    own.scatter_(1, vocab, _zipf(a["group_vocab"], a["group_zipf"]).expand(g, -1).contiguous())
    w = (1.0 - a["group_share"]) * background + a["group_share"] * own
    # expected document frequencies: over the groups, and over the lengths
    # weighted by the normal density of their quantiles
    z = torch.linspace(-4.0, 4.0, _DF_LENGTHS, dtype=torch.float64)
    pz = torch.exp(-0.5 * z * z)
    share = _inclusion(w, _lengths(a, z)).mean(0)
    df = cfg["rows"] * (pz[:, None] * share).sum(0) / pz.sum()
    idf = torch.log((1.0 + cfg["rows"]) / (1.0 + df)) + 1.0
    return {"w": w.to(torch.float32), "idf": idf.to(torch.float32)}


def rows(p: dict, cfg: dict, n: int, gen: torch.Generator):
    """``n`` documents drawn on the generator's device: a ``Corpus``, CSR
    float32 on the host."""
    a = cfg["generator_args"]
    dev = gen.device
    w, idf = p["w"].to(dev), p["idf"].to(dev)
    g, v = w.shape
    group = torch.randint(0, g, (n,), generator=gen, device=dev)
    length = _lengths(a, torch.randn(n, generator=gen, device=dev))
    cols, vals = [], []
    b = max(1, _BLOCK_ELEMS // v)
    for s in range(0, n, b):
        lb = length[s:s + b]
        u = torch.rand(lb.shape[0], v, generator=gen, device=dev)
        keys = torch.log(w[group[s:s + b]]) - torch.log(-torch.log(u))
        top = torch.topk(keys, int(lb.max()), dim=1).indices
        keep = torch.arange(top.shape[1], device=dev)[None, :] < lb[:, None]
        top = torch.sort(torch.where(keep, top, torch.full_like(top, v)), dim=1).values
        count = 1.0 + torch.poisson(torch.full(top.shape, float(a["tf_poisson"]), device=dev),
                                    generator=gen)
        val = torch.where(keep, count.to(torch.float64)
                          * idf[top.clamp(max=v - 1)].to(torch.float64), 0.0)
        val = val / torch.sqrt(torch.sum(val * val, dim=1, keepdim=True))
        cols.append(top[keep].to(torch.int32).cpu())
        vals.append(val[keep].to(torch.float32).cpu())
    indptr = np.concatenate([[0], np.cumsum(length.cpu().numpy())])
    out = Corpus((torch.cat(vals).numpy(), torch.cat(cols).numpy(), indptr), shape=(n, v))
    out.has_sorted_indices = True
    _check_distinct(out)
    return out


def _check_distinct(m: sparse.csr_matrix):
    """Raise if two rows are alike (same terms, same values)."""
    seen = set()
    for i in range(m.shape[0]):
        lo, hi = m.indptr[i], m.indptr[i + 1]
        key = (m.indices[lo:hi].tobytes(), m.data[lo:hi].tobytes())
        if key in seen:
            raise ValueError(f"row {i} repeats an earlier row; draw another data set")
        seen.add(key)
