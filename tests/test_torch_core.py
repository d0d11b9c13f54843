"""The port's planning library (``repro_torch.core``) against the
reference's (``repro.core``): the paper's tables, Algorithm 1's buffer
placement, the tile searches, the AIE simulator and the planner give
equal results, compared as plain dicts (``dataclasses.asdict``)."""

from __future__ import annotations

import dataclasses

import pytest

from repro.core import aiesim as jsim
from repro.core import buffer_placement as jbp
from repro.core import hw as jhw
from repro.core import paper_tables as jpt
from repro.core import planner as jplan
from repro.core import tile_search as jts
from repro_torch.core import aiesim as tsim
from repro_torch.core import buffer_placement as tbp
from repro_torch.core import hw as thw
from repro_torch.core import paper_tables as tpt
from repro_torch.core import planner as tplan
from repro_torch.core import tile_search as tts

PRECISIONS = sorted(jts.PAPER_TILES)


def _plain(x):
    """Dataclasses (also inside lists) as dicts; everything else as is."""
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    return x


@pytest.mark.parametrize("table", ["table2", "table2_search", "table3",
                                   "table4", "table5", "table6", "fig6",
                                   "staggered_placement"])
def test_paper_tables_equal_reference(table):
    assert _plain(getattr(tpt, table)()) == _plain(getattr(jpt, table)())


@pytest.mark.parametrize("name", PRECISIONS)
def test_buffer_placement_equals_reference(name):
    """Algorithm 1 and the two compiler models, their rule checks and
    simulated stall fractions, for each paper tile."""
    jp, tp = jhw.PRECISIONS[name], thw.PRECISIONS[name]
    jshape, tshape = jts.PAPER_TILES[name], tts.PAPER_TILES[name]
    assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
    for place in ("place_buffers", "place_buffers_location",
                  "place_buffers_unconstrained"):
        try:
            want = getattr(jbp, place)(jshape, jp)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                getattr(tbp, place)(tshape, tp)
            continue
        got = getattr(tbp, place)(tshape, tp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), place
        for assigned in (False, True):
            assert tbp.check_rules(got, assigned) == \
                jbp.check_rules(want, assigned)
    for strategy in (jbp.ADDRESS, jbp.LOCATION, jbp.UNCONSTRAINED):
        assert tbp.stall_fraction(strategy, tshape, tp) == \
            jbp.stall_fraction(strategy, jshape, jp)


@pytest.mark.parametrize("name", PRECISIONS)
def test_aie_search_and_simulator_equal_reference(name):
    jp, tp = jhw.PRECISIONS[name], thw.PRECISIONS[name]
    assert _plain(tts.search_aie_tiles(tp)) == _plain(jts.search_aie_tiles(jp))
    assert dataclasses.asdict(tsim.simulate_kernel(name)) == \
        dataclasses.asdict(jsim.simulate_kernel(name))
    for g in (1, 2, 4, 8):
        assert dataclasses.asdict(tsim.simulate_pack(name, g)) == \
            dataclasses.asdict(jsim.simulate_pack(name, g))
    assert dataclasses.asdict(tsim.simulate_array(name)) == \
        dataclasses.asdict(jsim.simulate_array(name))


@pytest.mark.parametrize("m,k,n,prec", [
    (8, 960, 1600, "bf16-bf16"), (488, 960, 2560, "bf16-bf16"),
    (512, 2560, 960, "bf16-bf16"), (3, 960, 49152, "bf16-bf16"),
    (1024, 4096, 4096, "int8-int8"), (100, 300, 700, "int8-int32")])
def test_tpu_tile_search_equals_reference(m, k, n, prec):
    """The TPU tile search the planner's cascade sweep calls, with its
    VMEM and gamma helpers."""
    jp, tp = jhw.PRECISIONS[prec], thw.PRECISIONS[prec]
    assert dataclasses.asdict(tts.search_tpu_tiles(m, k, n, tp)) == \
        dataclasses.asdict(jts.search_tpu_tiles(m, k, n, jp))
    assert tts.tile_vmem_bytes(128, 256, 512, 2, 2) == \
        jts.tile_vmem_bytes(128, 256, 512, 2, 2)
    assert tts.tile_gamma(128, 256, 128, k, tp.in_bytes, tp.out_bytes,
                          thw.TPU_V5E, tp) == \
        jts.tile_gamma(128, 256, 128, k, jp.in_bytes, jp.out_bytes,
                       jhw.TPU_V5E, jp)


@pytest.mark.parametrize("model_axis", [1, 2, 4, 8, 16])
def test_planner_equals_reference(model_axis):
    jsite = jplan.GemmSite("ffn_up", 4096, 960, 2560)
    tsite = tplan.GemmSite("ffn_up", 4096, 960, 2560)
    assert _plain(tplan.plan_cascade(tsite, 2, model_axis)) == \
        _plain(jplan.plan_cascade(jsite, 2, model_axis))
    assert dataclasses.asdict(tplan.best_cascade(tsite, 2, model_axis)) == \
        dataclasses.asdict(jplan.best_cascade(jsite, 2, model_axis))
    assert _plain(tplan.plan_block_schedules(512, 960, 2560, model_axis)) \
        == _plain(jplan.plan_block_schedules(512, 960, 2560, model_axis))
    names = [("qkv", 960, 1600), ("out", 960, 960), ("up", 960, 2560),
             ("down", 2560, 960), ("lm_head", 960, 49152)]
    tplan_ = tplan.plan_model([tplan.GemmSite(s, 512, k, n)
                               for s, k, n in names], 512, 960, 2560, 2,
                              model_axis)
    jplan_ = jplan.plan_model([jplan.GemmSite(s, 512, k, n)
                               for s, k, n in names], 512, 960, 2560, 2,
                              model_axis)
    assert tplan_.describe() == jplan_.describe()
    assert _plain(tplan_) == _plain(jplan_)


def test_core_exports_equal_reference():
    import repro.core
    import repro_torch.core
    assert sorted(repro_torch.core.__all__) == sorted(repro.core.__all__)
