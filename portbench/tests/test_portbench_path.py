"""CPU tests of the path-tracing cell, ``spd_tetra8.path``: its small run is
correct and spans its waves, a frame's answers pack into a row a pixel and
back, the entry refuses another scene, and each planted fault made for a
frame reads not correct: the noise ignored, one bounce wave's answers
replaced by the wave before's, and the shadow waves unbounded (under a
light inside the pyramid's hollow, where a shadow ray passes the light
and meets faces beyond it). The harness's own faults and its control run
on this cell in ``test_portbench_harness.py``, as on every cell.

Run: ``python -m pytest portbench/tests -q`` from the repository root.
"""

from __future__ import annotations

import pytest
import torch

from portbench.reference import path
from portbench.tests.test_portbench_harness import run_small, small_cell

CELL = "spd_tetra8.path"
WAVES = 3
HOLLOW = (0.1, -0.3, -0.2)  # inside the central hollow, off its centre


def test_the_small_run_is_correct_and_exact():
    res = run_small(small_cell(CELL))
    assert res["correct"], res["checks"]
    assert res["checks"]["flips"]["value"] == 0.0
    assert res["checks"]["shadow_flips"]["value"] == 0.0


def test_a_traced_run_spans_the_waves():
    res = run_small(small_cell(CELL), trace=True)
    assert res["correct"], res["checks"]
    spans = res["device"]["spans"]
    assert {w: spans[f"render/{w}"]["n"] for w in ("primary", "bounce",
                                                   "shadow", "shade")} == {
        "primary": 1.0, "bounce": 2.0, "shadow": 3.0, "shade": 3.0}
    assert spans["render"]["n"] == 1.0


def test_a_frame_packs_into_a_row_a_pixel_and_back():
    entry = small_cell(CELL).entry
    n = 5
    g = torch.Generator().manual_seed(1)

    def rand(*shape):
        return torch.rand((n, *shape), generator=g)

    out = [rand(3)]
    for _ in range(WAVES):
        out += [rand(3), rand(3), rand(),
                torch.randint(-1, 9, (n,), generator=g, dtype=torch.int32),
                rand(3), rand(3), rand(), rand() < 0.5]
    values, ids = entry.pack(tuple(out))
    assert values.shape == (n, 4 * WAVES + 3, 3)
    assert ids.shape == (n, 2 * WAVES) and ids.dtype == torch.int32
    back = entry.unpack((values, ids))
    assert len(back) == 1 + path.WAVE * WAVES
    for x, y in zip(back, out):
        assert torch.equal(x, y.to(x.dtype))
    assert torch.equal(values[:, -2, 1], out[1 + path.WAVE + 2])
    # answer by answer in memory: each is copied whole
    assert values.permute(1, 0, 2).is_contiguous() and ids.t().is_contiguous()


def test_the_entry_refuses_another_scene():
    cell = small_cell(CELL)
    a, b, c = (x.copy() for x in cell.entry._MAKER.make(3))
    a[7, 0] += 0.5
    with pytest.raises(ValueError, match="not it"):
        cell.entry.make(None, (a, b, c), "cpu", cell.traffic["entry"])
    with pytest.raises(ValueError, match="not it"):
        cell.entry.make(None, (a[:100], b[:100], c[:100]), "cpu",
                        cell.traffic["entry"])


def noise_ignored(call):
    """The generator's draw in place of the pixels' noise."""
    g = torch.Generator().manual_seed(0)

    def f(batch):
        drawn = torch.randn(batch[2].shape, generator=g)
        return call((batch[0], batch[1], drawn.to(batch[2].device)))
    return f


def bounce_replaced(call):
    """The last bounce wave's answers (t, triangle) replaced by the wave
    before's."""
    def f(batch):
        values, ids = (x.clone() for x in call(batch))
        values[:, -2, 2] = values[:, -2, 1]
        ids[:, 4] = ids[:, 2]
        return values, ids
    return f


@pytest.mark.parametrize("fault", [noise_ignored, bounce_replaced])
def test_a_broken_frame_is_not_correct(fault):
    res = run_small(small_cell(CELL), wrap=fault)
    assert not res["correct"], (fault.__name__, res["checks"])


def test_unbounded_shadow_waves_are_not_correct(monkeypatch):
    from bvh_tpu_torch import render

    cell = small_cell(CELL)
    monkeypatch.setitem(cell.entry.SHADING, "light_pos", HOLLOW)
    res = run_small(cell)
    assert res["correct"], res["checks"]
    bounded = render.trace_any_hit_tight

    def unbounded(*args, t_max=None, **kw):
        return bounded(*args, **kw)
    monkeypatch.setattr(render, "trace_any_hit_tight", unbounded)
    res = run_small(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["shadow_flips"]["value"] > 0.1
