"""The port's path tracer on the card against the benchmark's plain path
tracer (``portbench/reference/path.py``): a frame of the SPD ``tetra``
pyramid at size factor 5 (4,096 triangles), 64x64 jittered camera rays of
the database's view, ``bounces=2``, ``packet=1024``, judged as the cell
``spd_tetra8.path`` judges it (``portbench/entries/pathtracer.py``:
``numbers``) over 384 sampled pixels, against the cell's own limits; the
noise passed in against the generator's draw, bit for bit; and the frame
replayed as a CUDA graph (``graph=True``) against the frame run as usual,
bit for bit, on two frames in turn. Needs an
NVIDIA GPU and skips elsewhere; the file imports no JAX:

    python -m pytest tests/test_torch_render_path_cuda.py -q --noconftest
"""

import json
from pathlib import Path

import pytest
import torch

from portbench import check, plugin

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
BOUNCES = 2


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frame(cuda):
    from bvh_tpu_torch.ops import build_tight_scene
    from bvh_tpu_torch.render import make_pathtracer

    entry = plugin(ROOT, "entries", "pathtracer")
    tris_np = plugin(ROOT, "scenes", "spd_tetra").make(5)
    trace = make_pathtracer(build_tight_scene(*tris_np), tris_np,
                            bounces=BOUNCES, packet=1024, device=cuda,
                            **entry.SHADING)
    g = torch.Generator(device=cuda).manual_seed(2**31 + 99)
    rows = plugin(ROOT, "kinds", "camera").make(
        64 * 64, g, {"scene": "spd_tetra", "tile": 32, "bounces": BOUNCES},
        {"device": cuda, "tris": None})
    tris = tuple(torch.from_numpy(x).to(cuda) for x in tris_np)
    return entry, trace, rows, tris


def test_a_frame_on_the_card_is_within_the_cells_limits(frame):
    entry, trace, rows, tris = frame
    out = trace(*rows[:2], noise=rows[2], waves=True)
    torch.cuda.synchronize()
    idx = torch.randperm(rows[0].shape[0],
                         generator=torch.Generator().manual_seed(5))[:384]
    idx = idx.to(rows[0].device)
    found = entry.numbers(tuple(x[idx] for x in rows),
                          tuple(y[idx] for y in entry.pack(out)), tris)
    limits = json.loads((ROOT / "portbench" / "cells"
                         / "spd_tetra8.path.json").read_text())["limits"]
    ok, checks = check.judge(found, limits)
    assert ok, checks


def test_noise_passed_in_gives_the_generators_colours_on_the_card(frame,
                                                                  cuda):
    from bvh_tpu_torch import render

    _, trace, rows, _ = frame
    o, d, _ = rows
    drawn = trace(o, d, torch.Generator(device=cuda).manual_seed(3))
    g = torch.Generator(device=cuda).manual_seed(3)
    noise = torch.stack([render.bounce_noise(o.shape[0], g, cuda)
                         for _ in range(BOUNCES)], dim=1)
    assert torch.equal(drawn, trace(o, d, noise=noise))


def test_a_replayed_frame_is_the_frame_bit_for_bit(frame, cuda):
    from bvh_tpu_torch.ops import build_tight_scene
    from bvh_tpu_torch.render import make_pathtracer

    entry, trace, rows, _ = frame
    tris_np = plugin(ROOT, "scenes", "spd_tetra").make(5)
    graphed = make_pathtracer(build_tight_scene(*tris_np), tris_np,
                              bounces=BOUNCES, packet=1024, graph=True,
                              device=cuda, **entry.SHADING)
    g = torch.Generator(device=cuda).manual_seed(2**31 + 7)
    other = plugin(ROOT, "kinds", "camera").make(
        64 * 64, g, {"scene": "spd_tetra", "tile": 32, "bounces": BOUNCES},
        {"device": cuda, "tris": None})
    for batch in (rows, other, rows):
        want = trace(*batch[:2], noise=batch[2], waves=True)
        got = graphed(*batch[:2], noise=batch[2], waves=True)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    # the replay hands out the graph's own tensors; a second size has its
    # own graph
    again = graphed(*rows[:2], noise=rows[2], waves=True)
    assert again[0].data_ptr() == got[0].data_ptr()
    half = [x[:2048] for x in rows]
    assert torch.equal(graphed(*half[:2], noise=half[2]),
                       trace(*half[:2], noise=half[2]))
