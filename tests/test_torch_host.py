"""Host stages of the PyTorch port against the JAX reference, exactly.

Mesh tables, traces, FTL decomposition (both engines, incl. a GC-heavy
geometry), design lowering for all nine designs, nominal ordering and
packing — the inputs every lane scan sees.  These stages are numpy in both
packages, so every array must be equal element by element (dtype too).
"""
import numpy as np
import pytest

import repro.core.topology as jtopo
import repro.ssd.designs as jdes
import repro.ssd.sim as jsim
import repro.traces.generator as jgen
from repro.ssd import cost_optimized as j_cost
from repro.ssd import perf_optimized as j_perf
from repro.ssd.ftl import decompose_trace as j_decompose

import repro_torch.core.topology as ptopo
import repro_torch.ssd.designs as pdes
import repro_torch.ssd.sim as psim
import repro_torch.traces.generator as pgen
from repro_torch.ssd import cost_optimized as p_cost
from repro_torch.ssd import perf_optimized as p_perf
from repro_torch.ssd.ftl import decompose_trace as p_decompose

QUICK_WL = ("proj_3", "src2_1", "hm_0", "prxy_0", "YCSB_B", "ssd-10", "usr_0")
FTL_STATE = ("l2p", "p2l", "valid", "written", "erase_count", "is_free",
             "open_block", "next_page", "_stripe", "gc_events", "gc_page_moves",
             "read_precond_pages", "read_precond_gc_txns")


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert np.array_equal(a, b), f"{what} differs"


@pytest.mark.parametrize("rows,cols", [(1, 1), (2, 2), (3, 5), (8, 8), (4, 16)])
def test_build_mesh_tables(rows, cols):
    j, p = jtopo.build_mesh(rows, cols), ptopo.build_mesh(rows, cols)
    assert (j.n_nodes, j.n_links) == (p.n_nodes, p.n_links)
    for f in ("port_link", "port_neighbor", "fc_node", "link_endpoints"):
        _eq(getattr(p, f), getattr(j, f), f)
    for a, b in zip(ptopo.all_xy_paths(p), jtopo.all_xy_paths(j)):
        _eq(a, b, "all_xy_paths")


@pytest.mark.parametrize("wl", QUICK_WL + ("mix1",))
def test_traces_and_pages(wl):
    for seed in (0, 3):
        a, b = pgen.trace_for(wl, 300, seed), jgen.trace_for(wl, 300, seed)
        assert set(a) == set(b)
        for k in ("arrival_us", "is_read", "offset_bytes", "size_bytes", "tenant"):
            if k in b:
                _eq(a[k], b[k], f"{wl}.{k}")
        for cfg_p, cfg_j in ((p_perf(), j_perf()), (p_cost(), j_cost())):
            pa, pb = pgen.to_pages(a, cfg_p.page_bytes), jgen.to_pages(b, cfg_j.page_bytes)
            for k in ("arrival_us", "is_read", "offset_page", "n_pages"):
                _eq(pa[k], pb[k], f"{wl}.pages.{k}")
            assert pa["footprint_pages"] == pb["footprint_pages"]


def test_default_n_requests_and_registry():
    assert pgen.WORKLOADS == {k: tuple(v) for k, v in jgen.WORKLOADS.items()}
    assert pgen.MIXES == jgen.MIXES
    for name in tuple(jgen.WORKLOADS) + tuple(jgen.MIXES):
        assert pgen.default_n_requests(name) == jgen.default_n_requests(name)


DECOMP_CASES = {
    # (config kwargs, workload, requests, seed, footprint bytes, overprovision,
    #  arrival divisor, engine)
    "tiny": (dict(rows=2, cols=2, pages_per_block=64), "src2_1", 60, 3, None, 1.28, 16.0, "auto"),
    "full_perf": ({}, "hm_0", 200, 2, None, 1.28, 1.0, "auto"),
    "full_cost": ("cost", "mds_0", 200, 2, None, 1.28, 1.0, "auto"),
    "gc_heavy": (dict(rows=2, cols=2, pages_per_block=16), "prxy_0", 2500, 5, 1 << 20, 3.0, 1.0, "auto"),
    "scalar_engine": (dict(rows=2, cols=2, pages_per_block=64), "usr_0", 120, 1, None, 1.28, 1.0, "scalar"),
}


@pytest.mark.parametrize("case", sorted(DECOMP_CASES))
def test_decompose_trace(case):
    kw, wl, n, seed, fp, op, div, engine = DECOMP_CASES[case]
    if kw == "cost":
        cfg_p, cfg_j = p_cost(), j_cost()
    else:
        cfg_p, cfg_j = p_perf(**kw), j_perf(**kw)
    extra = {} if fp is None else dict(footprint_bytes=fp)
    out = []
    for gen, to_pages, cfg, dec in ((pgen, pgen.to_pages, cfg_p, p_decompose),
                                    (jgen, jgen.to_pages, cfg_j, j_decompose)):
        tr = dict(gen.gen_trace(wl, n, seed=seed, **extra))
        tr["arrival_us"] = tr["arrival_us"] / div
        pages = to_pages(tr, cfg.page_bytes)
        out.append(dec(cfg, pages, footprint_pages=int(pages["footprint_pages"]),
                       overprovision=op, engine=engine))
    a, b = out
    assert set(a) == set(b)
    for k in b:
        _eq(a[k], b[k], f"Transactions[{k}]")
    for attr in FTL_STATE:
        _eq(getattr(a.ftl, attr), getattr(b.ftl, attr), f"ftl.{attr}")
    assert a.n_requests == b.n_requests
    if case == "gc_heavy":
        assert b.ftl.gc_events > 100  # the case really exercises GC


@pytest.mark.parametrize("geom", [(2, 2), (8, 8), (3, 5)])
def test_lower_designs_all_nine(geom):
    rows, cols = geom
    names = tuple(jdes.DESIGNS)
    assert tuple(pdes.DESIGNS) == names
    for cfg_p, cfg_j in ((p_perf(rows=rows, cols=cols), j_perf(rows=rows, cols=cols)),
                         (p_cost(rows=rows, cols=cols), j_cost(rows=rows, cols=cols))):
        a = pdes.lower_designs(cfg_p, names)
        b = jdes.lower_designs(cfg_j, names)
        assert a._fields == b._fields
        for f in b._fields:
            _eq(getattr(a, f), getattr(b, f), f"LaneTables.{f}")
        assert pdes.sweep_layout(cfg_p) == tuple(jdes.sweep_layout(cfg_j))
    with pytest.raises(ValueError, match="unknown design"):
        pdes.lower_designs(p_perf(), ("baseline", "nope"))


@pytest.mark.parametrize("wl", ["src2_1", "prxy_0", "YCSB_B"])
def test_nominal_order_and_pack(wl):
    cfg_p, cfg_j = p_perf(rows=2, cols=2, pages_per_block=64), j_perf(rows=2, cols=2, pages_per_block=64)
    tr = dict(jgen.gen_trace(wl, 150, seed=4))
    tr["arrival_us"] = tr["arrival_us"] / 8.0
    pages = jgen.to_pages(tr, cfg_j.page_bytes)
    txns = j_decompose(cfg_j, pages, footprint_pages=int(pages["footprint_pages"]))
    order = jsim._nominal_order(cfg_j, txns)
    _eq(psim._nominal_order(cfg_p, txns), order, "nominal order")
    _eq(psim._nominal_times(cfg_p, txns)[0], jsim._nominal_times(cfg_j, txns)[0],
        "nominal times")
    pa, op_a = psim._pack_txns(cfg_p, txns, order)
    pb, op_b = jsim._pack_txns(cfg_j, txns, order)
    _eq(op_a, op_b, "op_ticks")
    assert pa._fields == pb._fields
    for f in pb._fields:
        _eq(getattr(pa, f), getattr(pb, f), f"TxnArrays.{f}")
