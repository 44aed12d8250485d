"""Carry the JAX package's state across to this package.

The simulator has no weights: its "parameters" are the page transactions
the FTL emits and the lowered design tables.  These helpers take them as
plain numpy arrays — ``np.asarray`` of each field of a
``repro.ssd.ftl.Transactions`` or ``repro.ssd.designs.LaneTables`` — so the
reference's exact inputs can be fed into this package's scan (this module
imports neither JAX nor the JAX package).
"""
from __future__ import annotations

import numpy as np

from repro_torch.ssd.designs import LaneTables
from repro_torch.ssd.ftl import Transactions

_TXN_FIELDS = ("arrival", "kind", "plane", "node", "row", "nbytes", "req")


def transactions_from_numpy(d, n_requests: int | None = None) -> Transactions:
    """Transactions from a mapping of numpy arrays (the reference's
    ``Transactions`` dict works as is).  ``n_requests`` defaults to the
    mapping's own attribute, else to the largest request id + 1."""
    txns = Transactions({k: np.asarray(d[k], np.int32) for k in _TXN_FIELDS})
    if n_requests is None:
        n_requests = getattr(d, "n_requests", None)
    if n_requests is None:
        req = txns["req"]
        n_requests = int(req.max()) + 1 if len(req) else 0
    txns.n_requests = int(n_requests)
    return txns


def lane_tables_from_numpy(d) -> LaneTables:
    """LaneTables from a mapping (or NamedTuple) of numpy arrays, one per
    field, stacked over designs."""
    get = (lambda k: d[k]) if hasattr(d, "keys") else (lambda k: getattr(d, k))
    return LaneTables(**{k: np.asarray(get(k)) for k in LaneTables._fields})
