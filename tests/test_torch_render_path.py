"""The port's path tracer (``bvh_tpu_torch/render.py``) against the plain
path tracer of the benchmark (``portbench/reference/path.py``: every wave
by float64 brute force, the same glue and shading) on the SPD ``tetra``
pyramid at size factor 3 (256 triangles), 32x32 jittered camera rays of the
database's view, ``bounces=2``; the bounce noise passed in against the
generator's draw; the frame's spans; ``graph=True`` off the card; and the
scene maker.

Tolerances, wave by wave (the reference runs its own waves, so they are
the same waves only while the answers agree; they do on this scene):

* rays each wave starts from: 1e-5 relative to the ray's reach. The port
  computes the hit point, the lift and the bounce direction in float32;
  each is a few roundings of numbers of the scene's size.
* closest hit: hit or miss equal on every ray. Against brute force on the
  wave's own rays: t within 1e-5 relative (the walks compute t in float32
  in the cluster's frame), the triangle the same or one that the ray meets
  within 1e-6 of that t (a hit on an edge two triangles share may take
  either). Against the reference's wave: t within 1e-5 of the ray's reach,
  since the rays themselves differ by that.
* shadow rays: occlusion equal, except where the occluder lies within the
  key truncation of t_max (``2 W 2**-23 t_max``), where the any-hit walk
  may count it either side (``trace_any_hit_tight``).
* colours: 1e-5 relative plus 1e-6 absolute, float32 shading of the same
  answers.
"""

import numpy as np
import pytest
import torch

from bvh_tpu_torch import obs, render
from bvh_tpu_torch.ops import build_tight_scene
from portbench import plugin
from portbench.reference import hits, path
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
SCENE = plugin(ROOT, "scenes", "spd_tetra")
CAMERA = plugin(ROOT, "kinds", "camera")
ENTRY = plugin(ROOT, "entries", "pathtracer")
BOUNCES = 2
SIDE = 32


@pytest.fixture(scope="module")
def frame():
    """The scene, its triangles (torch), the renderer, and one frame's
    camera rows and the port's answers with ``waves=True``."""
    tris_np = SCENE.make(3)
    scene = build_tight_scene(*tris_np)
    trace = render.make_pathtracer(scene, tris_np, bounces=BOUNCES,
                                   packet=128, device=CPU, **ENTRY.SHADING)
    g = torch.Generator().manual_seed(2**31 + 5)
    rows = CAMERA.make(SIDE * SIDE, g, {"scene": "spd_tetra", "tile": 32,
                                        "bounces": BOUNCES},
                       {"device": CPU, "tris": None})
    tris = tuple(torch.from_numpy(x) for x in tris_np)
    return tris, trace, rows, trace(*rows[:2], noise=rows[2], waves=True)


@pytest.fixture(scope="module")
def ref(frame):
    """The plain path tracer's frame of the same pixels and noise."""
    tris, _, rows, _ = frame
    return path.render(*rows, tris, ENTRY.SHADING)


def _waves(out):
    return [out[1 + path.WAVE * k:1 + path.WAVE * (k + 1)]
            for k in range(BOUNCES + 1)]


def test_the_frame_is_lit_shadowed_and_has_sky(frame):
    _, _, _, out = frame
    color = out[0]
    assert len(out) == 1 + path.WAVE * (BOUNCES + 1)
    assert torch.isfinite(color).all() and (color >= 0).all()
    first = _waves(out)[0]
    hit, occ = torch.isfinite(first[2]), first[7]
    assert 0.1 < float(hit.float().mean()) < 0.9
    assert occ[hit].any() and (~occ[hit]).any()
    assert not occ[~hit].any()


@pytest.mark.parametrize("wave", range(BOUNCES + 1))
def test_each_wave_matches_the_plain_path_tracer(frame, ref, wave):
    tris, _, rows, out = frame
    o, d, t, ids, sh_o, wl, dist, occ = _waves(out)[wave]
    o_r, d_r, t_r, ids_r, sh_o_r, wl_r, dist_r, occ_r = _waves(ref)[wave]
    live = ~(o_r == path.PARK).all(dim=-1)
    assert torch.equal(live, ~(o == path.PARK).all(dim=-1))
    hit, hit_r = torch.isfinite(t), torch.isfinite(t_r)
    assert torch.equal(hit[live], hit_r[live])
    lit = live & hit  # the lanes whose shadow ray lives
    assert lit.any() and torch.equal(lit, ~(sh_o == path.PARK).all(dim=-1))
    reach = torch.linalg.vector_norm(o_r, dim=-1) + torch.where(hit_r, t_r,
                                                                0.0)
    for x, x_r, m in ((o, o_r, live), (sh_o, sh_o_r, lit)):
        err = torch.linalg.vector_norm(x.double() - x_r, dim=-1)[m]
        assert (err <= 1e-5 * reach[m]).all()
    for x, x_r, m in ((d, d_r, live), (wl, wl_r, lit)):
        x_r = x_r / torch.linalg.vector_norm(x_r, dim=-1, keepdim=True)
        x = x.double() / torch.linalg.vector_norm(x.double(), dim=-1,
                                                  keepdim=True)
        assert (torch.linalg.vector_norm(x - x_r, dim=-1)[m] <= 1e-5).all()
    assert ((dist[lit].double() - dist_r[lit]).abs()
            <= 1e-5 * dist_r[lit]).all()
    # closest hit: t against brute force on the wave's own rays, and
    # against the reference's within the rays' own difference
    t_own, ids_own = hits.closest_hits(o[lit], d[lit], tris)
    assert ((t[lit].double() - t_own).abs() <= 1e-5 * t_own).all()
    assert ((t[lit].double() - t_r[lit]).abs() <= 1e-5 * reach[lit]).all()
    other = ids[lit].long() != ids_own
    if other.any():
        t_pl, outside, front = hits.on_triangles(
            o[lit][other], d[lit][other], tris, ids[lit][other].long())
        assert front.all() and (outside <= 1e-6).all()
        assert ((t_pl - t_own[other]).abs() <= 1e-6 * t_own[other]).all()
    # shadow rays: equal outside the key truncation band of t_max
    t_max = dist_r * path.SHADOW_REACH
    t_occ, _ = hits.closest_hits(sh_o_r, wl_r, tris)
    band = (t_occ - t_max).abs() <= 2 * 16 * 2.0 ** -23 * t_max
    differ = (occ != occ_r) & lit
    assert not (differ & ~band).any()
    assert not occ[~lit].any()


def test_the_colours_match_the_plain_path_tracer(frame, ref):
    _, _, _, out = frame
    assert torch.allclose(out[0].double(), ref[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_noise_passed_in_gives_the_generators_colours_bit_for_bit(frame,
                                                                   seed):
    _, trace, rows, _ = frame
    o, d, _ = rows
    drawn = trace(o, d, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    noise = torch.stack([render.bounce_noise(o.shape[0], g, CPU)
                         for _ in range(BOUNCES)], dim=1)
    given = trace(o, d, noise=noise)
    assert torch.equal(drawn, given)
    waves = trace(o, d, noise=noise, waves=True)
    assert torch.equal(waves[0], given)


def test_the_frame_takes_exactly_one_noise_source(frame):
    _, trace, rows, _ = frame
    o, d, noise = rows
    with pytest.raises(ValueError, match="exactly one"):
        trace(o, d)
    with pytest.raises(ValueError, match="exactly one"):
        trace(o, d, torch.Generator(), noise=noise)
    with pytest.raises(ValueError, match="noise"):
        trace(o, d, noise=noise[:, :1])


def test_a_frame_opens_its_wave_spans_and_counts_on_the_host(frame):
    _, trace, rows, out = frame
    obs.reset()
    with obs.tracing():
        on = trace(*rows[:2], noise=rows[2])
    snap = obs.snapshot()
    obs.reset()
    off = trace(*rows[:2], noise=rows[2])
    assert torch.equal(on, off) and torch.equal(on, out[0])
    spans = snap["spans"]
    assert {p: spans[p]["n"] for p in ("render", "render/primary",
                                       "render/bounce", "render/shadow",
                                       "render/shade")} == {
        "render": 1, "render/primary": 1, "render/bounce": 2,
        "render/shadow": 3, "render/shade": 3}
    # the trace entries' stages nest under the waves
    assert spans["render/primary/trace/walk"]["n"] == 1
    assert spans["render/bounce/trace/walk"]["n"] == 2
    assert spans["render/shadow/trace/walk"]["n"] == 3
    assert not [p for p in spans if p.count("/") == 1
                and p.split("/")[1] not in ("primary", "bounce", "shadow",
                                            "shade")]
    # the frame counts nothing of its own
    assert not [k for k in snap["counts"] if k.startswith("render")]


def test_graph_on_the_cpu_runs_the_frame_as_usual(frame):
    """``graph=True`` replays only on the card: on the CPU it is the frame
    run as usual, with its spans."""
    _, _, rows, out = frame
    scene = build_tight_scene(*SCENE.make(3))
    trace = render.make_pathtracer(scene, SCENE.make(3), bounces=BOUNCES,
                                   packet=128, graph=True, device=CPU,
                                   **ENTRY.SHADING)
    got = trace(*rows[:2], noise=rows[2], waves=True)
    assert all(torch.equal(x, y) for x, y in zip(got, out))
    obs.reset()
    with obs.tracing():
        trace(*rows[:2], noise=rows[2])
    assert obs.snapshot()["spans"]["render"]["n"] == 1
    obs.reset()


@pytest.mark.parametrize("sf", [0, 1, 2, 3])
def test_the_pyramid_has_4_to_the_sf_tetrahedra_wound_outwards(sf):
    a, b, c = SCENE.make(sf)
    assert a.dtype == np.float32 and a.shape == (4 ** (sf + 1), 3)
    centres, size = SCENE.tetra_centres(sf)
    n = np.cross(b - a, c - a).astype(np.float64)
    tri_centre = (a + b + c).astype(np.float64) / 3
    tet_centre = np.repeat(centres, 4, axis=0)
    assert (np.einsum("ij,ij->i", n, tri_centre - tet_centre) > 0).all()
    assert np.allclose(np.linalg.norm(n, axis=1), 4 * size ** 2 * np.sqrt(3))
    again = SCENE.make(sf)
    assert all(x.tobytes() == y.tobytes() for x, y in zip((a, b, c), again))


def test_the_pyramid_at_size_factor_8_has_262144_triangles_in_its_bounds():
    a, b, c = SCENE.make(8)
    assert a.shape == b.shape == c.shape == (262_144, 3)
    v = np.concatenate([a, b, c])
    assert v.min() == -1.0 and v.max() == 1.0
    # every vertex on the size factor's lattice, exactly
    assert np.array_equal(v * 256, np.round(v * 256))
