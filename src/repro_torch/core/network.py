"""Inter-datacenter network model for ``netdc_batch``.

Host-side numpy copy of ``repro/core/network.py``'s
``store_and_forward_delay`` and ``InterDCTopology``.  The arithmetic and
its order are unchanged, so the routing tables are bit-identical to the
reference's.
"""
from __future__ import annotations

import numpy as np


def store_and_forward_delay(payload_bytes: float, links: int, bw: float,
                            fixed_latency: float = 0.0,
                            overhead: float = 0.0) -> float:
    """The one closed-form store-and-forward delay every topology shares:
    ``links · payload·8/bw + fixed_latency + overhead`` (0 when co-located,
    i.e. ``links == 0`` ⇒ ρ = 0 in Eq. (2)).

    Float operations and their order are part of the engines' bit-exactness
    contract — :meth:`NetworkTopology.transfer_delay`, the vec workflow's
    precomputed edge delays, and the inter-DC matrices all evaluate exactly
    this expression.
    """
    if links == 0:
        return 0.0
    per_link = payload_bytes * 8.0 / bw
    return links * per_link + fixed_latency + overhead


class InterDCTopology:
    """Inter-datacenter network: per-pair link counts, bandwidth, latency.

    The multi-datacenter routing scenario (``netdc_batch``) models geo-
    distributed datacenters joined by wide-area links: datacenters sit on a
    metro ring with direct fiber between ring neighbours (1 store-and-
    forward link) and a backbone hop between everyone else (2 links), each
    link adding ``hop_latency_s``.  Transfer delay is the same closed form
    the rack topology uses (:func:`store_and_forward_delay`) — co-located
    jobs (``src == dst``) pay nothing.

    Explicit ``[D, D]`` matrices may be passed to override the generated
    ring layout (``links`` integer hop counts, ``bw`` bits/s, ``latency_s``
    fixed seconds per pair).
    """

    def __init__(self, n_dcs: int, *, link_bw: float = 10e9,
                 hop_latency_s: float = 0.02,
                 links=None, bw=None, latency_s=None):
        self.n_dcs = int(n_dcs)
        d = np.arange(self.n_dcs)
        ring = np.minimum(np.abs(d[:, None] - d[None, :]),
                          self.n_dcs - np.abs(d[:, None] - d[None, :]))
        if links is None:
            links = np.where(ring == 0, 0, np.where(ring == 1, 1, 2))
        self.links = np.asarray(links, np.int64)
        self.bw = np.broadcast_to(
            np.asarray(link_bw if bw is None else bw, np.float64),
            (self.n_dcs, self.n_dcs))
        if latency_s is None:
            latency_s = self.links * float(hop_latency_s)
        self.latency_s = np.broadcast_to(np.asarray(latency_s, np.float64),
                                         (self.n_dcs, self.n_dcs))

    def transfer_delay(self, src_dc: int, dst_dc: int,
                       payload_bytes: float) -> float:
        """Closed-form WAN transfer delay between two datacenters."""
        return store_and_forward_delay(
            payload_bytes, int(self.links[src_dc, dst_dc]),
            float(self.bw[src_dc, dst_dc]),
            float(self.latency_s[src_dc, dst_dc]))

    def delay_rows(self, src, payload_bytes):
        """``[J, D]`` delays for per-job (source, payload) — the routing
        table both the OO broker and the vec engine read.  Vectorized
        elementwise numpy: each entry is the *same* IEEE arithmetic, in the
        same order, as :meth:`transfer_delay`'s scalar form (asserted by
        tests), just computed as one array pass instead of J·D Python
        calls."""
        src = np.asarray(src, np.int64)
        payload = np.asarray(payload_bytes, np.float64)[:, None]
        links = self.links[src]                        # [J, D]
        per_link = payload * 8.0 / self.bw[src]
        return np.where(links == 0, 0.0,
                        links * per_link + self.latency_s[src])
