"""Lane scans of the PyTorch port against the JAX reference on meshes that
are not square.

On a 2x3 mesh the flash-controller section is wider than the number of
controllers (``F_pad = 3 > rows = 2``: padded, invalid FCs) and the link
section is the mesh's 7 links; on a 3x2 mesh the column buses of pnSSD are
fewer than the rows.  Every ``SimResult`` field of every design must be
equal, exactly, between ``repro_torch`` (plain versions on the CPU) and
``repro``.
"""
import pytest

import repro.ssd as J
from repro.traces.generator import gen_trace as j_gen
from repro.traces.generator import to_pages as j_pages

from port_parity import assert_same_result, jax_reference, torch_threads
import repro_torch.ssd as P
from repro_torch.convert import transactions_from_numpy

DESIGNS = ("baseline", "pssd", "pnssd", "nossd", "venice", "ideal",
           "venice_minimal", "venice_hold")
GEOMS = [(2, 3), (3, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def results():
    out = {}
    for rows, cols in GEOMS:
        cfg_j = J.cost_optimized(rows=rows, cols=cols, pages_per_block=64)
        tr = dict(j_gen("proj_3", 40, seed=rows * 10 + cols))
        tr["arrival_us"] = tr["arrival_us"] / 4.0
        pages = j_pages(tr, cfg_j.page_bytes)
        txns = J.decompose_trace(cfg_j, pages, int(pages["footprint_pages"]))
        with jax_reference():
            want = J.simulate_sweep(cfg_j, txns, DESIGNS, seeds=rows + cols)
        cfg_p = P.cost_optimized(rows=rows, cols=cols, pages_per_block=64)
        got = P.simulate_sweep(cfg_p, transactions_from_numpy(txns), DESIGNS,
                               seeds=rows + cols, device="cpu")
        out[(rows, cols)] = (got, want)
    return out


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("i", range(len(DESIGNS)), ids=DESIGNS)
def test_non_square_mesh_matches_jax(geom, i, results):
    got, want = results[geom]
    assert_same_result(got[i], want[i])
