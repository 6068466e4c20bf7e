"""Drives the PyTorch/CUDA port's closest-hit, any-hit, k-closest and
nearest-triangle paths (tight, legacy cluster and chained scenes), its
subtree-entry planners, its differentiable rendering, its dynamic scenes,
its general pure-tensor path, its io, bench.py's scale and ray-box legs and
the twins of the repository's five examples on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits nonzero before the
final line):

1. device: the card's name and power limit; builds the CUDA kernel
   sources and the host scene builder from the checkout's sources, in
   parallel.
2. kernels vs plain: on create_n_cubes(1000) with 65,536 reference-random
   and 65,536 aimed rays, every trace kernel against its plain PyTorch
   version on the same CUDA tensors (closest, bounded and gated walks; the
   gate; each walk's FRAME build, which host scenes launch, and its build
   without FRAME); with 65,536 points, both nearest kernels against theirs
   (unbounded, per-point radius, no bound refinement; FRAME and without)
   and the bound seed against its plain version (timed and with counts),
   and their FRAME
   builds (timed and counting) on a device grid build of the same cubes
   with 65,536 points about its triangles' centroids, sorted and unsorted;
   results must agree bit for bit.
3. main path: the 120k-triangle scene (create_n_cubes(10000)), 2,097,152
   reference rays through make_tracer(sort="octmorton", sweep=False), the
   same with sweep=True (identical results), and 1,048,576 aimed rays with
   sort="morton" and the exact winner recompute; 4,096 sampled rays of each
   leg against brute force over all triangles.
4. W=128: the 260k-triangle dense mesh, a 1024x1024 camera in 32x32 tiles
   through make_tracer(sort=None, sweep=False), brute-force checked; the
   package's diff.camera_rays against this script's numpy twin (the
   tracer takes raw directions and normalizes them, so the twin's
   unnormalized directions stay its input; the package's normalized rays
   must equal the ones the tracer makes from them).
5. timings (CUDA events, median of 7 after warm-up): rays/s of each leg
   (the aimed leg also with sweep=False), each leg's device time by kernel
   and idle share (torch.profiler); each kernel against its plain version
   on the main path's own sorted rows (every leg, gated and ungated; bit
   for bit), and both timed at those shapes beside the kernel's bound, the
   group walk as the path launches it (its FRAME build). The
   sweep gate's bound is the least work of any schedule (a fired packet's
   shortest walk to a fire, an unfired packet's every walk), counted on
   every ray, with the earlier bound (every ray to its own fire) beside
   it. The closest-hit epilogue kernel, launched once by each of phase 3's
   four calls, against its plain composition on the aimed leg's walk
   answers (the exact recompute and the un-sort) and the camera leg's
   (neither), bit for bit, both timed there with their inputs cold in L2
   (CUDA graphs over a ring of copies) beside the kernel's bound; so are
   the order kernels (the key, and the rows with the un-sort), launched by
   phase 3's calls (the key by the three sorted ones), on the aimed
   (morton) and random (octmorton) legs' rays.
6. nearest main path: 1,048,576 reference-random points (bench.py's
   nearest leg) against the 120k-triangle scene through nearest_tight in
   both walks (identical results), and 1,048,576 points near the dense
   mesh's surface with d_max=2.0 at W=128; 4,096 sampled points of each leg
   against brute force over all triangles.
7. nearest timings: points/s of each leg with its device breakdown; the
   bound seed against its plain version on the legs' own sorted rows, then
   each nearest kernel's FRAME build, which the path launches, against its
   plain version on the seeded rows (bit for bit), each timed there beside
   the kernel's bound.
8. pathtrace (bench.py's pathtrace leg): the path tracer over the dense
   mesh, 1024x1024 camera in 32x32 tiles, bounces=2, packet=1024, seed 0;
   colours finite and non-negative; 4,096 sampled shadow rays of the first
   wave against brute-force occlusion within t_max; that wave's sweep gate
   and the group walk's any mode, gated by it, against their plain versions
   on the wave's full rows; rays/s as bench.py counts them, with the device
   breakdown.
9. entry/exit legs on the 120k scene: the aimed rays through make_tracer on
   a wide=False build (equal to the aimed leg) and on a packed=True build
   (brute-force bounds), and trace_any_hit_tight with t_max at 1.2x (and
   0.8x) each ray's hit distance on the wide and the wide=False scene;
   the broadphase-only walk (trace_closest_hit_tight(skip_narrow=True),
   the entry/exit kernel's SKIP build) on the aimed and the sorted
   reference rays, every ray a miss; the sweep gate (plain and packed
   table) and the entry/exit kernel, gated by it as the aimed legs run it,
   against their plain versions on the legs' own sorted rows, timed there
   beside the kernel's bound; the SKIP build against its plain version and
   timed in turns beside the full walk on the same rows (the difference is
   the walk's leaf-test time).
10. legacy: build_cluster_scene over the 120k scene; legacy_random (the
   2,097,152 reference rays) and legacy_aimed (the 1,048,576 aimed rays,
   exact recompute) through trace_closest_hit, each sorted with sort_rays;
   brute-force bounds; legacy_aimed equal to the aimed leg of phase 3
   outside the near-tie and grazing-edge classes (each counted; the crack
   class must be empty);
   the cluster kernel against its plain version on each leg's rows (bit
   for bit), both timed there beside the kernel's bound.
11. chained, the slice's main path at full size: bench.py's sparse_1m leg
   (1,008,000 triangles in 11 parts, 2,097,152 rays), the aimed rays on the
   same chain (closest with the exact recompute; any hit at 1.2x and 0.8x
   each ray's hit), nearest_chained on 1,048,576 points, and k=4 closest
   hits on the 120k scene and on the chain; brute-force bounds, the parts'
   root gates, every kernel launch of the first four legs against its
   plain version on that launch's own inputs (bit for bit), timings and
   device breakdowns; then the ``kernels`` line.
12. planned: bench.py's aimed leg as the reference
   runs it, make_tracer(plan="key") on the aimed rays, equal to the
   unplanned leg of phase 3 and brute-force checked; the sampling planner
   (make_planner) and the seeded trace equal to the unplanned trace;
   bench.py's diff_fwd_bwd leg (render_depth_fast with the key plan's
   start_g, the loss over the hits and its gradients for a, b and c) with
   depth against brute force and the gradients against the same loss with
   the plain walk as the hard pass on the card; the group walk with the
   key plan's entries and with the sampling planner's hints and entries
   against its plain version and against itself without entries on the
   leg's own rows (bit for bit); planned and unplanned timed in turns,
   the diff leg in parts, work per ray and bounds.
13. dynamic scenes and the visit counters (bench.py's update_shapes_flat,
   tight_refit, refit_quality and roofline legs at full size, last):
   update_shapes on the 120k scene's SAH tree after moving half of its
   triangles (equal to the CPU's, consistent and tight); make_refitter on
   the same vertices (tables equal to the CPU's); at 1%, 10% and 50% churn
   the refit scene, a host rebuild and make_updater's chained scene, each
   tracing the 2,097,152 reference rays (octmorton, packet 8192, no sweep)
   with 4,096 of them and 4,096 aimed rays (exact recompute; the chained
   scene with the sweep gate) against brute force over the moved
   triangles, the refit precision class counted apart;
   build_tight_scene_device (grid and LBVH upper trees, equal to the
   CPU's) on the 120k scene and build_chained_scene_device on 1,008,000
   triangles, each tracing the aimed rays against brute force; nearest
   over the 10% update (both walks); count_visits_wide and
   count_visits_tight (a wide=False build) on the sorted reference rays
   and count_visits_nearest on the update's masked static part; every
   counting build against the timed build and the plain version's counts
   (bit for bit) on those rows and on the aimed rows; times, rays/s,
   device breakdowns, ns per serial unit and bounds. The device builds,
   refits and update deltas carry the exact cluster frame (``a_lo``), so
   their traces run the FRAME builds of the group walk and the entry/exit
   walk (launch counts checked); a far-frame leg traces 1,048,576 rays
   from [-60, 60]^3 aimed at centroids ~1e5 away through the grid device
   build, against float32 and float64 brute force (0 flips against
   float64; the flips of the same trace without the frame counted, a
   measurement only), and the shared-edge case (a grid device build of
   create_n_cubes(500), 8,192 far aimed rays, every ray checked) the same
   way; the refit leg is
   held to the rebuild's bounds (``REFIT_CLASS_MAX`` = 0); every FRAME
   build, timed and counting, against its plain version on the grid
   build's aimed and far rows, the LBVH build's (entry/exit walk) and the
   1% refit scene's random rows (bit for bit); rows 1 and 3 timed with and
   without FRAME on the same rows, in turns. The nearest far-frame leg:
   262,144 points about the triangle centroids (normal, scale 1.5, seed
   23) through nearest_tight on the grid device build in both walks (their
   FRAME builds), 4,096 of them against float64 brute force (the reported
   triangle the least outside the near-tie class; the same walk without
   the frame counted apart, a measurement only), both FRAME builds timed
   and counting against their plain versions, rows 5 and 6 timed with and
   without FRAME in turns. Then the host builds' legs: every scene the
   port builds carries a_lo, so the main path's walks are FRAME launches
   (phases 3, 6, 8, 9 and 12 check that each of their walks is one, and
   phases 5, 7, 8, 9, 12 and 17 hold, time and bound those builds);
   1,048,576 far
   aimed rays (seed 17) through the 120k host build's group walk, its
   wide=False and packed builds, the legacy ClusterScene and the sparse_1m
   host chain (its own far rays), 4,096 sampled against float64 brute
   force (0 flips; the same traces without a_lo counted beside), the
   shared-edge case's 8,192 rays on host builds of create_n_cubes(500)
   (every ray), the counting FRAME builds on the aimed rows, and FRAME
   against without in turns, kernel and end to end, on the random, aimed,
   aimed_entry_exit, aimed_packed, camera W=128, nearest and sparse_1m
   legs.
14. the general pure-tensor path at full size (``bvh/traverse.py``,
   ``bvh/ordered.py``, ``diff/render.py``; no kernel): the 120k scene as a
   build_sah FlatBvh (239,999 nodes) on the card; closest_hit_triangles on
   the 1,048,576 aimed rays (brute force; equal to make_tracer's trace
   outside the near-tie and grazing-edge classes), any_hit_triangles on
   the shadow rows (t_max 1.2x the hit; against trace_any_hit_tight),
   nearest_to_triangles on 262,144 of phase 7's points (brute force;
   nearest_tight outside the tie class), traverse_all with ray, box and
   ball queries on 65,536 queries (brute_force_collect on 256),
   nearest_traverse on 65,536 rays (traverse's shapes, ascending),
   render_depth forward and backward on the morton-sorted aimed rays
   (render_depth_fast: equal outside the classes, gradients within
   DIFF_GRAD_RTOL of the largest) and a float64 closest hit on
   tests/test_f64_2d.py's scene (float64 brute force at rtol 1e-12); each
   timed (median of 7), with its lock-step steps, host reads and idle
   share (not measured above PROFILE_MAX_STEPS steps a call).
15. io (bvh_tpu_torch.io, under 60 s): create_n_cubes(10000) written as
   OBJ text (positive, negative and i//i indices) and loaded: the
   generator's arrays, build_tight_scene's tables equal to phase 3's and
   make_tracer's aimed trace equal to phase 3's aimed leg bit for bit; its
   first 1,000 cubes written as quads: the fan's triangles; the 120k host
   scene, the grid device build (with a_lo) and phase 13's 1M chained
   device build saved and loaded in a temporary directory: tables equal,
   the far-frame trace and nearest query and the chain's aimed trace equal
   before and after bit for bit, the FRAME builds launched on the loaded
   scene; save and load seconds and file sizes.
16. parallel (bvh_tpu_torch.parallel on torch.distributed, under 60 s):
   NCCL at world size 1 (a single-rank group over an in-process store;
   one card is all there is); on the 120k scene sharded_trace_closest_hit
   on the 2,097,152 reference rays and, with the exact recompute, on the
   1,048,576 aimed rays (also through the grid device build, the FRAME
   build), sharded_trace_any_hit on the shadow rows (t_max 1.2x the hit)
   of the host scene and of a wide=False build (the entry/exit walk) and
   multihost_trace_closest_hit on the aimed rays, each bit-equal to the
   unsharded call and timed in turns with it (ratio printed);
   ray_scaling_report at {1}; on shard_scene(a, b, c, 1) and 262,144
   aimed rays sharded_render_depth (equal to render_depth bit for bit,
   brute-force checked), sharded_loss_and_grads (the unsharded autograd's
   gradients within DIFF_GRAD_RTOL of the largest) and two
   sharded_train_step calls towards depth + 0.25 at an lr that moves the
   vertices by many ulps (loss0 within 1e-3 of 0.0625, loss1 < loss0; the
   first step's vertices and loss1 against the unsharded autograd step's).
17. bench.py's scales and ray_aabb_1000 legs (under 60 s): 1,200 and 12,000
   triangles (create_n_cubes(100), (1000)), 2,097,152 rays each through
   make_tracer(sort="octmorton", packet 8192, the sweep on the 12k scene),
   4,096 sampled rays against brute force, the group walk (and the sweep
   gate) against its plain version on the leg's full sorted rows (bit for
   bit), rays/s with the device breakdown and against phase 5's 120k
   random leg, the walk's ms beside its bound; then the slab count kernel
   (csrc/slab_count.cu) on 131,072 rays (half aimed at box centres) x
   1,000 boxes, its count equal to the plain version's exactly (also with
   face-plane rays), both timed in turns, ns a test beside the bound.
18. the examples (under 90 s): each twin of examples/
   (bvh_tpu_torch.examples: camera_tracer, dynamic_scene, nearest_query,
   obj_render, pathtrace) through its main() at the original's default
   sizes, images to a temporary directory, each launching the port's
   kernels (the rows recorded), its own checks and: the camera's depth and
   the dynamic loop's last frame against brute force on 4,096 sampled rays,
   the OBJ render's hit share, loss and |grad|, the path tracer's colours
   and mean luminance.

Phase 2 also holds the group walk and the sweep gate on the 1,200-triangle
scale scene (65,536 of its rays; the 12,000-triangle scene and its rays are
phase 2's own), the FRAME builds of the group and entry/exit walks
(timed and counting) on the far frame's shared-edge case (a grid device
build of create_n_cubes(500), 8,192 far aimed rays), and the entry/exit
kernel (closest, bounded, any, gated,
hinted, packed; its SKIP build, timed and counting, with every ray a
miss), the group walk's any mode and hints, the sweep on a
packed table and with a pre-gate, and the legacy cluster kernel (relative,
global frame, broadphase only) against their plain versions. The kernels
that run a warp of rays or points together, the legacy cluster walk, both
nearest walks and the group walk (whose leaf tests the warp shares), are
also held there on unsorted rows, where a warp's lanes diverge the most.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from bvh_tpu_torch import (Aabb, AabbQuery, Ball, BallQuery, Ray, RayQuery,
                           native, point_triangle_distance_squared,
                           ray_intersects_aabb, ray_intersects_triangle)
from bvh_tpu_torch import obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.diff import camera_rays as package_camera_rays
from bvh_tpu_torch.io import (load_chained_scene, load_obj_triangles,
                              load_tight_scene, save_chained_scene,
                              save_tight_scene)
from bvh_tpu_torch.diff import (render_depth, render_depth_fast, render_hits,
                                render_hits_fast)
from bvh_tpu_torch.bvh import (FlatBvh, any_hit_triangles,
                               brute_force_closest_hit,
                               brute_force_collect, build_sah,
                               closest_hit_triangles, nearest_to_triangles,
                               nearest_traverse, traverse_all, update_shapes)
from bvh_tpu_torch.ops import (build_chained_scene,
                               build_chained_scene_device,
                               build_cluster_scene, build_tight_scene,
                               build_tight_scene_device, count_visits_nearest,
                               count_visits_tight, count_visits_wide,
                               make_key_planner, make_planner,
                               make_refitter, make_tracer, make_updater,
                               nearest_chained, nearest_tight,
                               sort_points_device, sort_rays,
                               trace_any_hit_chained, trace_any_hit_tight,
                               trace_closest_hit, trace_closest_hit_chained,
                               trace_closest_hit_seeded,
                               trace_closest_hit_tight, trace_k_closest,
                               trace_k_closest_chained)
from bvh_tpu_torch.examples import camera_tracer as ex_camera
from bvh_tpu_torch.examples import dynamic_scene as ex_dynamic
from bvh_tpu_torch.examples import nearest_query as ex_nearest
from bvh_tpu_torch.examples import obj_render as ex_obj
from bvh_tpu_torch.examples import pathtrace as ex_pathtrace
from bvh_tpu_torch.ops import cluster_trace as ct_mod
from bvh_tpu_torch.ops import epilogue as epi_mod
from bvh_tpu_torch.ops import nearest as near_mod
from bvh_tpu_torch.ops import order as order_mod
from bvh_tpu_torch.ops import slab as slab_mod
from bvh_tpu_torch.ops import sweep as sweep_mod
from bvh_tpu_torch.ops import tight as tight_mod
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops import wide as wide_mod
from bvh_tpu_torch.ops.trace import _dev, _ray_rows, sort_rays_device
from bvh_tpu_torch.render import hit_frames, make_pathtracer, shadow_rays

# the general path's module (``bvh_tpu_torch.bvh.traverse`` names the
# function): its lock-step step and host-read counters
trav_mod = importlib.import_module("bvh_tpu_torch.bvh.traverse")

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
N_SAMPLE = 4096  # rays or points per leg checked against brute force
REPS = 7
PLAIN_CHUNK = 1 << 23  # rays (points) x cluster width per plain walk call
N_POINTS = 1 << 20  # points per nearest leg (bench.py's nearest leg)
SURFACE_D_MAX = 2.0  # the narrow-band leg's search radius
LEGACY_PLAIN_CHUNK = 1 << 18  # rays per call of the plain legacy walk
# diff_fwd_bwd's gradients against its plain-walk twin: the same hits and
# the same float32 recompute; only the order of the scatter-adds into the
# vertex tables may differ (a triangle sums ~100 rays)
DIFF_GRAD_RTOL = 1e-4
CRACK_BAND = 3e-3  # barycentric distance from an edge of the crack class:
# 2^-9 of a unit on two axes, over a unit triangle


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, CUDA-event timed."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the port's CUDA kernels, as the profiler names them (after "void " for a
# templated one): "(anonymous namespace)::<name>(...)"
PORT_KERNELS = ("wide_trace_kernel", "sweep_kernel", "tight_trace_kernel",
                "cluster_trace_kernel", "nearest_wide_kernel",
                "nearest_entry_exit_kernel", "nearest_seed_kernel",
                "slab_count_kernel", "closest_epilogue_kernel",
                "ray_bounds_kernel", "ray_key_kernel", "ray_rows_kernel",
                "ray_unsort_kernel")


def is_port_kernel(key: str) -> bool:
    name = key.removeprefix("void ").removeprefix("(anonymous namespace)::")
    return name.split("(")[0].split("<")[0] in PORT_KERNELS


def n_launched(kernel: str) -> int:
    """Launches of ``kernel`` so far (its ``launch.<kernel>`` counter)."""
    return obs.counted(f"launch.{kernel}")


def port_launches() -> int:
    """Launches of the port's kernels so far: the ``launch.<kernel>``
    counters (the counting builds' included); a build suffix
    (``.frame``, ``.any``, ...) counts a subset of its kernel's launches."""
    return sum(v for k, v in obs.snapshot()["counts"].items()
               if k.startswith("launch.") and "." not in k[len("launch."):])


def device_breakdown(fn, e2e_ms: float, attempts: int = 3) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler, device
    events only) and the idle share of the call's unprofiled time
    ``e2e_ms``: the share in which no kernel ran.

    The profiler has dropped some of the port's kernels from a trace (a
    whole call's events once; a single 104 ms launch another time), so a
    profile counts only if it holds one event for every launch the port's
    wrappers counted during it (``is_port_kernel``). Up to ``attempts``
    profiles are taken; where none is whole, the leg's device time is "not
    measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        before = port_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        made = port_launches() - before
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        seen = sum(e.count for e in events if is_port_kernel(e.key))
        if seen == made and events:
            break
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:90])
                   for e in events), reverse=True)
    if seen != made or not events:
        return {"kernels_ms": "not measured", "e2e_ms": e2e_ms,
                "idle_share": "not measured", "profiles": attempt,
                "port_launches": made, "port_events": seen,
                "top": [{"ms": ms, "calls": n, "name": k}
                        for ms, n, k in rows[:8]]}
    busy = sum(r[0] for r in rows)
    return {"kernels_ms": busy, "e2e_ms": e2e_ms,
            "idle_share": 1.0 - busy / e2e_ms, "profiles": attempt,
            "port_launches": made,
            "top": [{"ms": ms, "calls": n, "name": k} for ms, n, k in rows[:8]]}


def build_all() -> dict:
    """Builds the kernel libraries and the host builder in parallel."""
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported and fatal below
            errors.append(f"{fn.__module__}: {e}")

    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (wide_mod.load, sweep_mod.load, near_mod.load,
                          tight_mod.load, ct_mod.load, slab_mod.load,
                          epi_mod.load, order_mod.load,
                          native.load)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        fail("build: " + " | ".join(errors))
    built = {k.removeprefix("lib_build_s."): v
             for k, v in obs.snapshot()["counts"].items()
             if k.startswith("lib_build_s.")}
    return {"wall_s": time.perf_counter() - t0, **built}


def camera_rays(eye, look_at, up, fov_deg, width, height):
    """Pinhole camera rays through pixel centres, row-major (numpy twin of
    the reference's camera_rays)."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(look_at, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    cam_up = np.cross(right, fwd)
    tan_half = np.float32(np.tan(np.deg2rad(fov_deg) * 0.5))
    xs = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0
    px, py = np.meshgrid(xs * tan_half * (width / height), ys * tan_half,
                         indexing="xy")
    dirs = (fwd[None, None, :] + px[..., None] * right[None, None, :]
            + py[..., None] * cam_up[None, None, :]).reshape(-1, 3)
    return (np.broadcast_to(eye, dirs.shape).astype(np.float32),
            dirs.astype(np.float32))


def brute_hits(o, d, tris_dev, k: int, chunk: int = 64):
    """The ``k`` smallest hit distances of every ray over all triangles,
    ascending (+inf padded): the front-facing hits (plain PyTorch on the
    card)."""
    a, b, c = tris_dev
    rays = Ray.create(o, d)
    out = []
    for s in range(0, rays.origin.shape[0], chunk):
        r = Ray(*(x[s:s + chunk, None, :] for x in rays))
        dist = ray_intersects_triangle(r, a[None], b[None], c[None]).distance
        out.append(dist.topk(k, dim=1, largest=False).values)
    return torch.cat(out)


def brute_force(o, d, tris_dev):
    """Closest t of every ray over all triangles."""
    return brute_hits(o, d, tris_dev, 1)[:, 0]


def check_vs_brute(leg: str, o, d, t_trace, tris_dev, seed: int) -> dict:
    idx = np.random.default_rng(seed).choice(len(o), N_SAMPLE, replace=False)
    t_bf = brute_force(o[idx], d[idx], tris_dev).cpu().numpy()
    t_tr = t_trace[idx]
    hit_bf, hit_tr = np.isfinite(t_bf), np.isfinite(t_tr)
    agree = float((hit_bf == hit_tr).mean())
    both = hit_bf & hit_tr
    rel = float(np.max(np.abs(t_tr[both] - t_bf[both]) / t_bf[both])) \
        if both.any() else 0.0
    res = {"leg": leg, "sampled": N_SAMPLE, "mask_agreement": agree,
           "max_rel_t_err": rel, "hit_fraction_sampled": float(hit_bf.mean())}
    check(agree >= 0.9999, f"{leg}: mask agreement {agree} < 0.9999")
    check(rel <= 2e-4, f"{leg}: max rel t err {rel} > 2e-4")
    return res


def phase_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain version on the same tensors."""
    a, b, c = tb.create_n_cubes(1000)
    scene = build_tight_scene(a, b, c)
    gn, grp = _dev(scene.gnodes, dev), _dev(scene.groups, dev)
    rec = records(scene, dev)
    sn, sr = _dev(scene.smem_nodes, dev), node_recs(scene.smem_nodes, dev)
    n = 65536
    o, d = tb.create_rays(n, seed=tb.seed_state_after(1000))
    ao, ad = tb.aimed_rays(a, n)
    n = min(len(o), len(ao))
    out, worst = {}, {"wide_trace": 0.0, "sweep_gate": 0.0}
    rows_of = {}
    shuffle = torch.from_numpy(np.random.default_rng(13).permutation(n)).to(dev)
    for leg, (lo, ld, mode) in {"random": (o, d, "octmorton"),
                                "aimed": (ao, ad, "morton"),
                                "random_unsorted": (o, d, None),
                                "aimed_unsorted": (ao, ad, None)}.items():
        perm = (shuffle if mode is None else
                sort_rays_device(lo, ld, mode=mode, device=dev)[0])
        rays = Ray.create(lo, ld, device=dev).take(perm)
        inf = torch.full((n,), float("inf"), device=dev)
        t_max = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev) * 60.0
        rows = _ray_rows(rays, inf)
        rows_b = _ray_rows(rays, t_max)
        rows_of[leg] = rows
        res = {}
        for packet in (1024, 8192):
            g_k = sweep_mod.sweep_gate(sr, rows, packet)
            g_p = sweep_mod.sweep_gate_plain(sn, rows, packet)
            gb_k = sweep_mod.sweep_gate(sr, rows_b, packet)
            gb_p = sweep_mod.sweep_gate_plain(sn, rows_b, packet)
            torch.cuda.synchronize()
            bad = int((g_k != g_p).sum() + (gb_k != gb_p).sum())
            worst["sweep_gate"] = max(
                worst["sweep_gate"], float((g_k - g_p).abs().max()),
                float((gb_k - gb_p).abs().max()))
            res[f"gate_mismatch_p{packet}"] = bad
            res[f"gate_open_p{packet}"] = int(g_k.sum())
            check(bad == 0, f"{leg}: sweep gate differs from plain ({bad})")
        gate = sweep_mod.sweep_gate(sr, rows, 1024)
        cases = {
            "closest": dict(rows=rows, bounded=False, gate=None),
            "bounded": dict(rows=rows_b, bounded=True, gate=None),
            "gated": dict(rows=rows, bounded=False, gate=gate),
        }
        # the FRAME build, which the host scene's walks launch, and the
        # build without FRAME (a scene whose caller set a_lo=None)
        for (name, cs), frame in itertools.product(cases.items(),
                                                   (True, False)):
            kw = dict(gate=cs["gate"], packet=1024, bounded=cs["bounded"],
                      a_lo=a_lo_of(scene, dev, frame))
            key = name if frame else f"{name}_without_frame"
            tk, ik = wide_mod.wide_trace(rec, grp, cs["rows"], scene.width,
                                         scene.gdepth, **kw)
            tp, ip = wide_mod.wide_trace_plain(gn, grp, cs["rows"],
                                               scene.width, **kw)
            torch.cuda.synchronize()
            differ = int(((tk.view(torch.int32) != tp.view(torch.int32))
                          | (ik != ip)).sum())
            fin = torch.isfinite(tk) & torch.isfinite(tp)
            err = float((tk[fin] - tp[fin]).abs().max()) if fin.any() else 0.0
            worst["wide_trace"] = max(worst["wide_trace"], err)
            res[f"{key}_rays_differ"] = differ
            res[f"{key}_hits"] = int((ik >= 0).sum())
            check(differ == 0, f"{leg}/{key}: {differ} rays differ from plain")
        out[leg] = res
    # the plain versions' time at this size (the random leg)
    rows = rows_of["random"]
    plain_ms = {
        "wide_trace": cuda_ms(lambda: wide_mod.wide_trace_plain(
            gn, grp, rows, scene.width, a_lo=a_lo_of(scene, dev)), reps=5,
            warmup=1),
        "sweep_gate": cuda_ms(lambda: sweep_mod.sweep_gate_plain(
            sn, rows, 8192), reps=5, warmup=1),
    }
    return {"legs": out, "max_abs_err": worst, "plain_ms": plain_ms,
            "rays": n, "triangles": int(a.shape[0])}


def phase_frame_kernels(dev) -> dict:
    """Phase 2's FRAME leg: the group and entry/exit walks' FRAME builds,
    timed and counting, against their plain versions on the shared-edge
    case (``shared_edge_case``: a grid device build of create_n_cubes(500),
    8,192 far aimed rays), unsorted and morton-sorted; bit for bit."""
    edge = shared_edge_case(dev)
    sc = edge["scene"]
    W = int(sc.width)
    rec, recs = records(sc, dev), node_recs(sc.smem_nodes, dev)
    out = {}
    for mode in (None, "morton"):
        rows = trace_rows(*edge["rays"], mode)
        for name, kernel, plain in (
                ("wide_trace_frame",
                 lambda **kw: wide_mod.wide_trace(rec, sc.groups, rows, W,
                                                  sc.gdepth, a_lo=sc.a_lo,
                                                  **kw),
                 lambda **kw: wide_plain_chunked(sc.gnodes, sc.groups, rows,
                                                 W, a_lo=sc.a_lo, **kw)),
                ("tight_trace_frame",
                 lambda **kw: tight_mod.tight_trace(recs, sc.groups, rows, W,
                                                    a_lo=sc.a_lo, **kw),
                 lambda **kw: tight_plain_chunked(sc.smem_nodes, sc.groups,
                                                  rows, W, a_lo=sc.a_lo,
                                                  **kw))):
            key = f"{name}/{mode or 'unsorted'}"
            timed = kernel()
            same = all(bits_equal(x, y) for x, y in zip(timed, plain()))
            check(same, f"{key}: the FRAME build differs from its plain "
                        "version")
            out[key] = {"rays": int(rows.shape[1]), "bit_equal": same,
                        "hits": int(torch.isfinite(timed[0]).sum()),
                        "counting": hold_counting_build(
                            f"{key}/count", kernel(counts=True), timed,
                            plain(counts=True))}
    return out


def random_hints(ids, p: int, k: int, seed: int):
    """[p, k] int32 hints drawn from the valid ids ``ids``; every fourth
    packet's hints are off (-1 in its first slot)."""
    h = np.random.default_rng(seed).choice(np.asarray(ids), size=(p, k))
    h = h.astype(np.int32)
    h[::4, 0] = -1
    return h


def same_bits(t_k, i_k, t_p, i_p) -> int:
    """Rays whose t bits or lane ids differ between kernel and plain."""
    return int(((t_k.view(torch.int32) != t_p.view(torch.int32))
                | (i_k != i_p)).sum())


def finite_err(t_k, t_p) -> float:
    fin = torch.isfinite(t_k) & torch.isfinite(t_p)
    return float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0


def phase_trace_modes(dev, n: int = 65536) -> dict:
    """Phase 2, slice 3: the entry/exit kernel (closest, bounded, any,
    gated, hinted; f32 and packed tables), the group walk's any mode and
    hints, and the sweep on a packed table and with a pre-gate, each against
    its plain version on 65,536 sorted random and aimed rays of
    create_n_cubes(1000). Results must agree bit for bit."""
    a, b, c = tb.create_n_cubes(1000)
    scene = build_tight_scene(a, b, c)
    scene_p = build_tight_scene(a, b, c, packed=True)
    grp = _dev(scene.groups, dev)
    grp_p = _dev(scene_p.groups, dev)
    gn, rec = _dev(scene.gnodes, dev), records(scene, dev)
    sn, pn = _dev(scene.smem_nodes, dev), _dev(scene_p.packed_nodes, dev)
    sr, pr = (node_recs(scene.smem_nodes, dev),
              node_recs(scene_p.packed_nodes, dev))
    packet = 1024
    p = n // packet
    o, d = tb.create_rays(n, seed=tb.seed_state_after(1000))
    ao, ad = tb.aimed_rays(a, n)
    leaves = np.nonzero(scene.smem_nodes[6] < 0)[0]
    leaves_p = np.nonzero(scene_p.packed_nodes[3] < 0)[0]
    out, err = {}, {"tight_trace": 0.0, "wide_trace": 0.0, "sweep_gate": 0.0}
    for leg, (lo, ld, mode) in {"random": (o, d, "octmorton"),
                                "aimed": (ao, ad, "morton")}.items():
        perm, _ = sort_rays_device(lo, ld, mode=mode, device=dev)
        rays = Ray.create(lo, ld, device=dev).take(perm)
        inf = torch.full((n,), float("inf"), device=dev)
        t_max = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev) * 60.0
        rows, rows_b = _ray_rows(rays, inf), _ray_rows(rays, t_max)
        pre = torch.from_numpy(np.resize(np.array([1, 1, 0], np.int32), p)).to(dev)
        res = {}
        # the sweep on the packed table and with a pre-gate
        for name, (table, packed, pg) in {
                "sweep_packed": (pn, True, None),
                "sweep_pre_gate": (sn, False, pre),
                "sweep_packed_pre_gate": (pn, True, pre)}.items():
            for rr in (rows, rows_b):
                g_k = sweep_mod.sweep_gate(pr if packed else sr, rr, packet,
                                           packed=packed, pre_gate=pg)
                g_p = sweep_mod.sweep_gate_plain(table, rr, packet,
                                                 packed=packed, pre_gate=pg)
                torch.cuda.synchronize()
                bad = int((g_k != g_p).sum())
                err["sweep_gate"] = max(err["sweep_gate"],
                                        float((g_k - g_p).abs().max()))
                res[f"{name}_mismatch"] = res.get(f"{name}_mismatch", 0) + bad
                check(bad == 0, f"{leg}/{name}: sweep gate differs from plain")
        gate = sweep_mod.sweep_gate(sr, rows, packet)
        gate_p = sweep_mod.sweep_gate(pr, rows, packet, packed=True)
        hints = torch.from_numpy(random_hints(leaves, p, 4, 1)).to(dev)
        hints_p = torch.from_numpy(random_hints(leaves_p, p, 4, 2)).to(dev)
        hints_w = torch.from_numpy(random_hints(scene.gslot, p, 4, 3)).to(dev)
        tight_cases = {
            "closest": (sn, grp, False, rows, {}),
            "bounded": (sn, grp, False, rows_b, {"bounded": True}),
            "any": (sn, grp, False, rows, {"mode": "any"}),
            "any_bounded": (sn, grp, False, rows_b,
                            {"mode": "any", "bounded": True}),
            "gated": (sn, grp, False, rows, {"gate": gate}),
            "hinted": (sn, grp, False, rows, {"hints": hints}),
            "packed": (pn, grp_p, True, rows, {}),
            "packed_any_bounded": (pn, grp_p, True, rows_b,
                                   {"mode": "any", "bounded": True}),
            "packed_gated_hinted": (pn, grp_p, True, rows,
                                    {"gate": gate_p, "hints": hints_p}),
        }
        # each FRAME build, as the host scenes launch it, and each build
        # without FRAME
        for (name, (table, gr, packed, rr, kw)), frame in itertools.product(
                tight_cases.items(), (True, False)):
            a_lo = a_lo_of(scene_p if packed else scene, dev, frame)
            key = name if frame else f"{name}_without_frame"
            tk, ik = tight_mod.tight_trace(pr if packed else sr, gr, rr,
                                           scene.width, packed=packed,
                                           packet=packet, a_lo=a_lo, **kw)
            tp, ip = tight_mod.tight_trace_plain(table, gr, rr, scene.width,
                                                 packed=packed, packet=packet,
                                                 a_lo=a_lo, **kw)
            torch.cuda.synchronize()
            differ = same_bits(tk, ik, tp, ip)
            err["tight_trace"] = max(err["tight_trace"], finite_err(tk, tp))
            res[f"tight_{key}_rays_differ"] = differ
            res[f"tight_{key}_hits"] = int((ik >= 0).sum())
            check(differ == 0,
                  f"{leg}/tight {key}: {differ} rays differ from plain")
        wide_cases = {
            "any": (rows, {"mode": "any"}),
            "any_bounded": (rows_b, {"mode": "any", "bounded": True}),
            "hinted": (rows, {"hints": hints_w}),
            "any_gated": (rows, {"mode": "any", "gate": gate}),
        }
        for (name, (rr, kw)), frame in itertools.product(wide_cases.items(),
                                                         (True, False)):
            a_lo = a_lo_of(scene, dev, frame)
            key = name if frame else f"{name}_without_frame"
            tk, ik = wide_mod.wide_trace(rec, grp, rr, scene.width,
                                         scene.gdepth, packet=packet,
                                         a_lo=a_lo, **kw)
            tp, ip = wide_mod.wide_trace_plain(gn, grp, rr, scene.width,
                                               packet=packet, a_lo=a_lo, **kw)
            torch.cuda.synchronize()
            differ = same_bits(tk, ik, tp, ip)
            err["wide_trace"] = max(err["wide_trace"], finite_err(tk, tp))
            res[f"wide_{key}_rays_differ"] = differ
            res[f"wide_{key}_hits"] = int((ik >= 0).sum())
            check(differ == 0,
                  f"{leg}/wide {key}: {differ} rays differ from plain")
        # the SKIP build (skip_narrow), timed and counting: every ray a
        # miss, its visits the plain walk's
        skip_cases = {
            "skip": (sr, sn, grp, False, rows, {}),
            "skip_bounded": (sr, sn, grp, False, rows_b, {"bounded": True}),
            "skip_gated_hinted": (sr, sn, grp, False, rows,
                                  {"gate": gate, "hints": hints}),
            "skip_packed": (pr, pn, grp_p, True, rows, {})}
        for name, (rec_, table, gr, packed, rr, kw) in skip_cases.items():
            for counts in (False, True):
                got = tight_mod.tight_trace(rec_, gr, rr, scene.width,
                                            packed=packed, packet=packet,
                                            counts=counts, skip_narrow=True,
                                            **kw)
                want = tight_mod.tight_trace_plain(
                    table, gr, rr, scene.width, packed=packed, packet=packet,
                    counts=counts, skip_narrow=True, **kw)
                torch.cuda.synchronize()
                same = all(bits_equal(x, y) for x, y in zip(got, want))
                miss = (bool(torch.isinf(got[0]).all())
                        and bool((got[1] == -1).all()))
                key = f"tight_{name}" + ("_counts" if counts else "")
                res[key] = {"equal": same, "all_miss": miss}
                if counts:
                    res[key].update(visits=int(got[2].sum()),
                                    fires=int(got[3].sum()))
                    miss = miss and res[key]["fires"] == 0
                check(same and miss, f"{leg}/{key}: the SKIP build differs "
                                     f"from its plain version: {res[key]}")
        out[leg] = res
    return {"legs": out, "max_abs_err": err, "rays": n,
            "triangles": int(a.shape[0])}


def plain_chunked(plain, tables: tuple, rows, width: int, gate=None,
                  packet: int = 8192, hints=None, start_g=None, **kw):
    """A trace walk's plain version, ``plain(*tables, rows, width, ...)``,
    over chunks of PLAIN_CHUNK // width rays (each ray walks on its own;
    chunks are whole packets), so that its batched leaf tests stay within a
    few GB at W=128. ``gate``, ``hints`` and ``start_g``: per packet, cut
    with the chunks; ``kw``: the mode options."""
    chunk = max(PLAIN_CHUNK // width, packet)
    parts = []
    for s in range(0, rows.shape[1], chunk):
        per = {k: v[s // packet:(s + chunk) // packet] for k, v in
               (("gate", gate), ("hints", hints), ("start_g", start_g))
               if v is not None}
        parts.append(plain(*tables, rows[:, s:s + chunk].contiguous(), width,
                           packet=packet, **per, **kw))
    return tuple(torch.cat(x) for x in zip(*parts))


def wide_plain_chunked(gn, grp, rows, width: int, **kw):
    return plain_chunked(wide_mod.wide_trace_plain, (gn, grp), rows, width,
                         **kw)


def tight_plain_chunked(table, grp, rows, width: int, **kw):
    return plain_chunked(tight_mod.tight_trace_plain, (table, grp), rows,
                         width, **kw)


def compare_main_shapes(kernel_rows: dict, gated_scene, err: dict):
    """Each kernel against its plain version on the main path's own rows:
    the group walk (its FRAME build, as the path launches it on host
    scenes) ungated on every leg, and gated at packet 8192 (as the
    sweep=True tracers run it) on the legs of ``gated_scene``, whose gates
    are compared too. t bits, lane ids and gates must be equal. Returns the
    per-leg counts and ``err`` raised to the largest |kernel - plain|."""
    out = {}
    for leg, (rows, sc) in kernel_rows.items():
        g_, r_ = _dev(sc.gnodes, rows.device), _dev(sc.groups, rows.device)
        res = {"rays": rows.shape[1], "width": sc.width}
        gates = {"ungated": None}
        if sc is gated_scene:
            sn = _dev(sc.smem_nodes, rows.device)
            g_k = sweep_mod.sweep_gate(node_recs(sc.smem_nodes, rows.device),
                                       rows, 8192)
            g_p = sweep_mod.sweep_gate_plain(sn, rows, 8192)
            bad = int((g_k != g_p).sum())
            err["sweep_gate"] = max(err["sweep_gate"],
                                    float((g_k - g_p).abs().max()))
            res.update(gate_mismatch=bad, gates_open=int(g_k.sum()),
                       gates=g_k.numel())
            check(bad == 0, f"{leg}: sweep gate differs from plain ({bad})")
            gates["gated"] = g_k
        a_lo = a_lo_of(sc, rows.device)
        for case, gate in gates.items():
            tk, ik = wide_mod.wide_trace(records(sc, rows.device), r_, rows,
                                         sc.width, sc.gdepth, gate=gate,
                                         packet=8192, a_lo=a_lo)
            tp, ip = wide_plain_chunked(g_, r_, rows, sc.width, gate=gate,
                                        a_lo=a_lo)
            differ = int(((tk.view(torch.int32) != tp.view(torch.int32))
                          | (ik != ip)).sum())
            fin = torch.isfinite(tk) & torch.isfinite(tp)
            if fin.any():
                err["wide_trace"] = max(err["wide_trace"],
                                        float((tk[fin] - tp[fin]).abs().max()))
            res[f"{case}_rays_differ"] = differ
            res[f"{case}_hits"] = int((ik >= 0).sum())
            check(differ == 0, f"{leg}/{case}: {differ} rays differ from plain")
        out[leg] = res
    return out, err


L2_BYTES = 50 << 20  # the H100's L2


def graph_ms(fn, inputs: tuple, calls: int = 24, reps: int = 5,
             cold: bool = True) -> float:
    """Device ms a call of ``fn(*inputs)``, its inputs cold in L2 where
    ``cold``.

    ``calls`` calls are captured as one CUDA graph and replayed: a call that
    launches little costs the host more than the card, so events around one
    eager call would time the host. Cold, each call takes the next of a
    ring of copies of ``inputs`` (tensors or None) that holds at least four
    times the L2, so what a call reads has left the L2 since its copy's
    last call; warm, every call reads the same inputs."""
    nbytes = sum(x.nbytes for x in inputs if x is not None)
    copies = -(-4 * L2_BYTES // nbytes) if cold else 0
    ring = [inputs] + [tuple(None if x is None else x.clone() for x in inputs)
                       for _ in range(copies)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs)  # loads what it runs
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for k in range(calls):
            fn(*ring[k % len(ring)])
    return cuda_ms(g.replay, reps=reps, warmup=1) / calls


def epilogue_leg(scene, od, dd, sort, packet: int, sweep: bool,
                 tris9=None) -> dict:
    """The closest-hit epilogue's kernel (``ops/epilogue.py``) against its
    plain composition (``ops/trace.py::_epilogue_plain``) on a leg's walk
    answers as ``make_tracer`` hands them on: rays ``od``, ``dd`` on the
    card sorted by ``sort`` (un-sorted after; None: as given), walked at
    ``packet`` (``sweep``), the winners recomputed against the [n_tris, 9]
    table ``tris9`` where given.

    Bit for bit (``rows_differ``); both timed with their inputs cold in L2
    (``graph_ms``), the kernel also warm (``ms_l2_warm``: its inputs in L2,
    as in the pipeline, where the walk has just written t and lane); and
    the kernel's bound: the bytes it cannot avoid at the HBM peak. Those are
    per ray t and lane read and t, u, v, id written (24), the un-sort's
    index (8), per hit the ray's o and d (24, with the recompute), and once
    each tri_map entry and triangle (4 and 36) that some hit reads: a table
    entry read by several hits comes from L2 after the first."""
    dev = od.device
    inv = None
    if sort is not None:
        perm, inv = sort_rays_device(od, dd, bits=2, mode=sort)
        od, dd = od[perm], dd[perm]
    rays = Ray.create(od, dd)
    n = od.shape[0]
    tm = torch.full((n,), float("inf"), device=dev)
    rows = _ray_rows(rays, tm)
    t, lane = trace_mod._walk(scene, rows, packet, sweep, False, "closest",
                              trace_mod._traces_wide(scene))
    tri_map = _dev(scene.tri_map, dev)

    def kernel(rows, t, lane, tri_map, tris9, inv):
        return tuple(epi_mod.closest_epilogue(
            rows, t, lane, tri_map,
            None if tris9 is None else tris9.split(3, dim=1), False, inv))

    def plain(o, d, invd, t, lane, tri_map, tris9, inv, tm):
        return tuple(trace_mod._epilogue_plain(
            types.SimpleNamespace(tri_map=tri_map), Ray(o, d, invd), tris9,
            t, lane, tm, False, inv))

    got = kernel(rows, t, lane, tri_map, tris9, inv)
    want = plain(*rays, t, lane, tri_map, tris9, inv, tm)
    differ = int(torch.stack([
        (x.view(torch.int32) if x.is_floating_point() else x)
        != (y.view(torch.int32) if y.is_floating_point() else y)
        for x, y in zip(got, want)]).any(0).sum())
    check(differ == 0, f"epilogue: {differ} rays differ from plain")
    hit = torch.isfinite(t)
    hits = int(hit.sum())
    lanes = lane[hit].clamp(0, tri_map.shape[0] - 1)
    nbytes = (24 * n + (0 if inv is None else 8 * n)
              + 4 * int(torch.unique(lanes).numel()))
    if tris9 is not None:
        ids = got[3][got[3] >= 0]
        nbytes += 24 * hits + 36 * int(torch.unique(ids).numel())
    k_in = (rows, t, lane, tri_map, tris9, inv)
    return {"rays": n, "hits": hits, "rows_differ": differ,
            "ms": graph_ms(kernel, k_in),
            "ms_l2_warm": graph_ms(kernel, k_in, cold=False),
            "plain_ms": graph_ms(plain, (*rays, t, lane, tri_map, tris9, inv,
                                         tm), calls=8),
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bytes": nbytes}


def order_leg(od, dd, mode: str) -> dict:
    """The tracer's order kernels (``ops/order.py``) against their plain
    composition on a leg's rays ``od``, ``dd`` on the card, as
    ``make_tracer(sort=mode)`` takes them: the key (``ray_key`` against
    ``ops/trace.py::_sort_key_plain``) and the rows in the order of the
    key's stable argsort with the un-sort beside them (``ray_rows`` against
    ``_sorted_rows_plain``: ``_inverse``'s scatter, ``_take``,
    ``Ray.create`` and ``_prologue``).

    Bit for bit (``key_differ``, ``rows_differ``); each timed with its
    inputs cold in L2 (``graph_ms``) and warm, beside its bound, the bytes
    it cannot avoid at the HBM peak: the key reads o and d and writes the
    key (24 + 4 bytes a ray), the rows (two launches: the gather, then the
    un-sort's scatter) read ``perm``, o and d and write 13 rows and the
    un-sort (32 + 60); and the plain composition's time."""
    n = od.shape[0]

    def key(o, d):
        return order_mod.ray_key(o, d, mode, 2)

    def key_plain(o, d):
        return trace_mod._sort_key_plain(o, d, 2, mode)

    rows, rows_plain = order_mod.ray_rows, trace_mod._sorted_rows_plain
    k = key(od, dd)
    key_differ = int((k != key_plain(od, dd)).sum())
    perm = trace_mod._sort_perm(k)
    got, want = rows(od, dd, perm), rows_plain(od, dd, perm)
    rows_differ = int(((got[0].view(torch.int32)
                        != want[0].view(torch.int32)).any(0)
                       | (got[1] != want[1])).sum())
    check(key_differ == 0, f"order: {key_differ} keys differ from plain")
    check(rows_differ == 0, f"order: {rows_differ} rays' rows differ from "
          "plain")
    k_in, r_in = (od, dd), (od, dd, perm)
    key_bytes, rows_bytes = 28 * n, 92 * n
    return {"rays": n, "mode": mode, "key_differ": key_differ,
            "rows_differ": rows_differ,
            "key": {"ms": graph_ms(key, k_in),
                    "ms_l2_warm": graph_ms(key, k_in, cold=False),
                    "plain_ms": graph_ms(key_plain, k_in, calls=8),
                    "bound_ms": key_bytes / PEAK_BYTES * 1e3,
                    "bytes": key_bytes},
            "rows": {"ms": graph_ms(rows, r_in),
                     "ms_l2_warm": graph_ms(rows, r_in, cold=False),
                     "plain_ms": graph_ms(rows_plain, r_in, calls=8),
                     "bound_ms": rows_bytes / PEAK_BYTES * 1e3,
                     "bytes": rows_bytes}}


def fp32_issue_rate() -> float:
    """float32 instructions per second without FMA pairing: 128 lanes per
    SM, times the SMs, times the card's maximum SM clock (nvidia-smi)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 128.0 * sms * mhz * 1e6


def trace_sync(tracer, o_dev, d_dev):
    out = tracer(o_dev, d_dev)
    torch.cuda.synchronize()
    return out


def roofline(ops: float, nbytes: float):
    """The least time (ms) the card could take for ``ops`` float32
    operations and ``nbytes`` moved, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def a_lo_of(sc, dev, frame: bool = True):
    """The scene's exact-frame table on ``dev`` for a FRAME build (every
    scene the port builds carries one, so the main path's walks are FRAME
    builds), else None (a build without FRAME, measured only)."""
    return _dev(sc.a_lo, dev).contiguous() if frame else None


def near_kernel(kind: str, sc, rows, refine: bool = True,
                frame: bool = True, counts: bool = False):
    """One launch of the nearest kernel ``kind`` ("wide" or "entry_exit")
    over ``sc``'s tables; ``frame``: its FRAME build (``sc.a_lo``), as the
    path launches it; False: the build without FRAME."""
    dev = rows.device
    grp = _dev(sc.groups, dev)
    a_lo = a_lo_of(sc, dev, frame)
    if kind == "wide":
        return near_mod.nearest_wide(_dev(sc.gnodes, dev), grp, rows,
                                     sc.width, sc.gdepth, refine=refine,
                                     counts=counts, a_lo=a_lo)
    return near_mod.nearest_entry_exit(_dev(sc.smem_nodes, dev), grp, rows,
                                       sc.width, refine=refine,
                                       counts=counts, a_lo=a_lo)


def near_plain(kind: str, sc, rows, refine: bool = True,
               counts: bool = False, frame: bool = True):
    """The plain version of nearest kernel ``kind`` over chunks of
    PLAIN_CHUNK // W points (each point walks on its own), so that its
    batched narrowphase stays within a few GB at W=128."""
    dev = rows.device
    grp = _dev(sc.groups, dev)
    a_lo = a_lo_of(sc, dev, frame)
    if kind == "wide":
        table, fn = _dev(sc.gnodes, dev), near_mod.nearest_wide_plain
    else:
        table, fn = _dev(sc.smem_nodes, dev), near_mod.nearest_entry_exit_plain
    chunk = PLAIN_CHUNK // sc.width
    parts = [fn(table, grp, rows[:, s:s + chunk].contiguous(), sc.width,
                refine=refine, counts=counts, a_lo=a_lo)
             for s in range(0, rows.shape[1], chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def near_compare(kind: str, sc, rows, refine: bool = True,
                 frame: bool = True):
    """Nearest kernel ``kind`` against its plain version on the same rows:
    (points whose d2 bits or lane ids differ, hits, largest |kernel - plain|
    over finite d2)."""
    dk, ik = near_kernel(kind, sc, rows, refine, frame)
    dp, ip = near_plain(kind, sc, rows, refine, frame=frame)
    torch.cuda.synchronize()
    differ = int(((dk.view(torch.int32) != dp.view(torch.int32))
                  | (ik != ip)).sum())
    fin = torch.isfinite(dk) & torch.isfinite(dp)
    err = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    return differ, int((ik >= 0).sum()), err


def seed_compare(sc, rows) -> tuple:
    """The bound seed's kernel against its plain version on copies of
    ``rows``: (points whose seeded row or group tests differ, the seeded
    rows)."""
    gn = _dev(sc.gnodes, rows.device)
    got, want = rows.clone(), rows.clone()
    tests = near_mod.nearest_seed(gn, got, counts=True)
    timed = rows.clone()
    near_mod.nearest_seed(gn, timed)
    tests_p = near_mod.nearest_seed_plain(gn, want, counts=True)
    torch.cuda.synchronize()
    differ = ((got.view(torch.int32) != want.view(torch.int32)).any(dim=0)
              | (timed.view(torch.int32) != want.view(torch.int32)).any(dim=0)
              | (tests != tests_p))
    return int(differ.sum()), timed


def phase_nearest_kernels(dev) -> dict:
    """Phase 2, nearest: both nearest kernels against their plain versions
    on 65,536 points of create_n_cubes(1000), half reference-random and
    half near the triangles, sorted and unsorted."""
    a, b, c = tb.create_n_cubes(1000)
    scene = build_tight_scene(a, b, c)
    n = 65536
    o = tb.create_rays(n // 2, seed=tb.seed_state_after(1007))[0]
    rng = np.random.default_rng(5)
    cen = (a + b + c) / 3.0
    near = cen[rng.integers(0, len(cen), n // 2)] + rng.normal(size=(n // 2, 3))
    pts_u = torch.from_numpy(np.concatenate([o, near]).astype(np.float32)).to(dev)
    perm, _ = sort_points_device(pts_u, device=dev)
    pts = pts_u[perm]
    rows = near_mod.point_rows(pts, None)
    d2, _ = near_kernel("wide", scene, rows)
    # a per-point radius between 0 and twice the nearest distance: about
    # half of the points find a triangle
    u = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(3),
                   device=dev)
    rows_b = near_mod.point_rows(pts, torch.sqrt(d2) * 2.0 * u)
    out, err = {}, {"nearest_wide": 0.0, "nearest_tight": 0.0,
                    "nearest_seed": 0.0}
    shuffle = torch.from_numpy(np.random.default_rng(12).permutation(n)).to(dev)
    for case, (r, refine) in {
            "unbounded": (rows, True), "radius": (rows_b, True),
            "no_refine": (rows, False),
            "unsorted": (near_mod.point_rows(pts_u, None), True),
            "unsorted_radius": (rows_b[:, shuffle].contiguous(), True)}.items():
        if refine:
            differ, _ = seed_compare(scene, r)
            out[f"seed/{case}"] = {"points_differ": differ}
            check(differ == 0, f"seed/{case}: {differ} points differ from "
                               "plain")
        for (kind, name), frame in itertools.product(
                (("wide", "nearest_wide"), ("entry_exit", "nearest_tight")),
                (True, False)):
            differ, hits, e = near_compare(kind, scene, r, refine, frame)
            err[name] = max(err[name], e)
            key = f"{kind}/{case}" + ("" if frame else "_without_frame")
            out[key] = {"points_differ": differ, "hits": hits}
            check(differ == 0, f"{key}: {differ} points differ from plain")
    # the FRAME builds: a device grid build of the same cubes (its Morton
    # clusters' frame origins lie up to ~1e5 from their triangles) and
    # 65,536 points about the triangles' centroids, sorted and unsorted
    dscene = build_tight_scene_device(
        *(torch.from_numpy(x).to(dev) for x in (a, b, c)))
    check(dscene.a_lo is not None, "the device build carries no a_lo")
    rng = np.random.default_rng(23)
    pf_u = torch.from_numpy((cen[rng.integers(0, len(cen), n)]
                             + rng.normal(scale=1.5, size=(n, 3)))
                            .astype(np.float32)).to(dev)
    pf = pf_u[sort_points_device(pf_u, device=dev)[0]]
    err.update(nearest_wide_frame=0.0, nearest_tight_frame=0.0)
    counters = {"wide": "launch.nearest_wide.frame",
                "entry_exit": "launch.nearest_entry_exit.frame"}
    for case, r in {"frame": near_mod.point_rows(pf, None),
                    "frame_unsorted": near_mod.point_rows(pf_u, None)}.items():
        differ, _ = seed_compare(dscene, r)
        out[f"seed/{case}"] = {"points_differ": differ}
        check(differ == 0, f"seed/{case}: {differ} points differ from plain")
        for kind, name in (("wide", "nearest_wide_frame"),
                           ("entry_exit", "nearest_tight_frame")):
            before = obs.counted(counters[kind])
            differ, hits, e = near_compare(kind, dscene, r, frame=True)
            check(obs.counted(counters[kind]) == before + 1,
                  f"{kind}/{case}: the FRAME build was not launched")
            err[name] = max(err[name], e)
            out[f"{kind}/{case}"] = {"points_differ": differ, "hits": hits}
            check(differ == 0,
                  f"{kind}/{case}: {differ} points differ from plain")
            if case == "frame":
                # the FRAME counting builds, against the plain counts
                got = near_kernel(kind, dscene, r, frame=True, counts=True)
                want = near_plain(kind, dscene, r, counts=True, frame=True)
                same = all(bits_equal(x, y) for x, y in zip(got, want))
                out[f"{kind}/frame_counts"] = {"equal": same}
                check(same, f"{kind}: the FRAME counting build differs from "
                            "its plain version")
    return {"points": n, "triangles": int(a.shape[0]), "cases": out,
            "max_abs_err": err}


def brute_nearest(p, tris_dev):
    """The smallest squared distance from each point to all triangles
    (plain PyTorch on the card), in chunks of points."""
    a, b, c = tris_dev
    chunk = max(1, (1 << 22) // a.shape[0])
    return torch.cat([point_triangle_distance_squared(
        p[s:s + chunk, None, :], a[None], b[None], c[None]).amin(dim=1)
        for s in range(0, p.shape[0], chunk)])


def check_nearest_vs_brute(leg: str, pts_dev, sid, dist, tris_dev, seed: int,
                           d_max: float | None = None) -> dict:
    """N_SAMPLE points of a leg against brute force: |dist - bd| <= 1e-5 bd
    + 1e-2; the returned triangle's brute squared distance equals the
    smallest within rtol 1e-4, atol 1e-5; with ``d_max``, -1 exactly beyond
    it and a triangle within it (outside a 1e-5 band)."""
    idx = torch.from_numpy(np.random.default_rng(seed).choice(
        pts_dev.shape[0], N_SAMPLE, replace=False)).to(pts_dev.device)
    p, s, d = pts_dev[idx], sid[idx], dist[idx]
    bd2 = brute_nearest(p, tris_dev)
    bd = torch.sqrt(bd2)
    if d_max is None:
        check(bool((s >= 0).all()), f"{leg}: a point found no triangle")
    else:
        check(bool((s[bd >= d_max * (1 + 1e-5)] == -1).all()),
              f"{leg}: a point beyond d_max found a triangle")
        check(bool((s[bd < d_max * (1 - 1e-5)] >= 0).all()),
              f"{leg}: a point within d_max found none")
    hit = s >= 0
    err = (d[hit] - bd[hit]).abs()
    a, b, c = tris_dev
    w = s[hit].to(torch.int64)
    wd2 = point_triangle_distance_squared(p[hit], a[w], b[w], c[w])
    res = {"leg": leg, "sampled": N_SAMPLE,
           "max_abs_err": float(err.max()) if hit.any() else 0.0,
           "max_rel_err": float((err / bd[hit].clamp_min(1e-6)).max())
           if hit.any() else 0.0,
           "hit_fraction_sampled": float(hit.float().mean())}
    check(bool((err <= 1e-5 * bd[hit] + 1e-2).all()),
          f"{leg}: distance off brute force by {res['max_abs_err']}")
    check(bool(torch.isclose(wd2, bd2[hit], rtol=1e-4, atol=1e-5).all()),
          f"{leg}: a returned triangle is not the nearest")
    return res


def ties_only(p, sid_a, d_a, sid_b, d_b, tris_dev) -> bool:
    """Whether two results for the same points differ only in the tie and
    key-truncation class: distances within rtol 1e-5 and both winners'
    brute-force distances within 1e-5 relative."""
    a, b, c = tris_dev
    wa, wb = sid_a.to(torch.int64), sid_b.to(torch.int64)
    da = torch.sqrt(point_triangle_distance_squared(p, a[wa], b[wa], c[wa]))
    db = torch.sqrt(point_triangle_distance_squared(p, a[wb], b[wb], c[wb]))
    return (bool(((sid_a >= 0) == (sid_b >= 0)).all())
            and bool(torch.isclose(d_a, d_b, rtol=1e-5, atol=0).all())
            and bool(torch.isclose(da, db, rtol=1e-5, atol=0).all()))


def nearest_points(tris_d, dev):
    """The nearest legs' points on the card: bench.py's N_POINTS random
    points, and N_POINTS points scattered (normal, scale 1) about the
    centroids of the dense mesh ``tris_d``."""
    pr = torch.from_numpy(tb.create_rays(
        N_POINTS, seed=tb.seed_state_after(10007))[0]).to(dev)
    rng = np.random.default_rng(4)
    cen = (tris_d[0] + tris_d[1] + tris_d[2]) / 3.0
    ps = (cen[rng.integers(0, len(cen), N_POINTS)]
          + rng.normal(scale=1.0, size=(N_POINTS, 3))).astype(np.float32)
    return pr, torch.from_numpy(ps).to(dev)


def nearest_rows(pr_dev, ps_dev):
    """The point rows the nearest kernels take on the two legs, sorted as
    ``nearest_tight`` sorts them: the random points without a radius, the
    surface points with d_max = SURFACE_D_MAX."""
    dev = pr_dev.device
    perm_r, _ = sort_points_device(pr_dev, device=dev)
    perm_s, _ = sort_points_device(ps_dev, device=dev)
    return (near_mod.point_rows(pr_dev[perm_r], None),
            near_mod.point_rows(ps_dev[perm_s], torch.full(
                (ps_dev.shape[0],), SURFACE_D_MAX, device=dev)))


def nearest_phases(dev, card: str, scene, tris, scene_d, tris_d, issue: float,
                   err: dict) -> list:
    """Phases 6 and 7: the nearest main path, its checks and timings.
    Returns the two nearest kernels' entries of the ``kernels`` line."""
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris)
    trisd_dev = tuple(torch.from_numpy(x).to(dev) for x in tris_d)
    pr_dev, ps_dev = nearest_points(tris_d, dev)
    legs = {
        "nearest_random": lambda: nearest_tight(scene, pr_dev),
        "nearest_random_entry_exit": lambda: nearest_tight(scene, pr_dev,
                                                           wide=False),
        "nearest_surface_w128": lambda: nearest_tight(
            scene_d, ps_dev, d_max=SURFACE_D_MAX),
    }

    # the nearest main path: every count is zero before and read after
    obs.reset()
    res = {leg: fn() for leg, fn in legs.items()}
    torch.cuda.synchronize()
    launches = {"nearest_wide": n_launched("nearest_wide"),
                "nearest_tight": n_launched("nearest_entry_exit"),
                "nearest_seed": n_launched("nearest_seed")}
    emit("nearest_main_path_launches", **launches,
         nearest_wide_frame=n_launched("nearest_wide.frame"),
         nearest_tight_frame=n_launched("nearest_entry_exit.frame"))
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the nearest main path")
    # host builds carry a_lo: every walk of the path is a FRAME launch
    check(n_launched("nearest_wide.frame") == launches["nearest_wide"]
          and (n_launched("nearest_entry_exit.frame")
               == launches["nearest_tight"]),
          "a nearest walk of the main path did not take the FRAME build")

    for leg, (sid, dist) in res.items():
        check(sid.shape == (N_POINTS,) and dist.shape == (N_POINTS,)
              and sid.dtype == torch.int32, f"{leg}: output shape or type")
        hit = sid >= 0
        check(bool((torch.isfinite(dist) == hit).all())
              and bool((dist[hit] >= 0).all()), f"{leg}: distance values")
    (sw, dw), (se, de) = res["nearest_random"], res["nearest_random_entry_exit"]
    differ = (sw != se) | (dw.view(torch.int32) != de.view(torch.int32))
    n_differ = int(differ.sum())
    check(n_differ == 0 or ties_only(pr_dev[differ], sw[differ], dw[differ],
                                     se[differ], de[differ], tris_dev),
          f"the entry/exit walk differs from the group walk on {n_differ} "
          "points outside the tie class")
    sid_s = res["nearest_surface_w128"][0]
    emit("nearest_main_path", triangles=[int(tris[0].shape[0]),
                                         int(tris_d[0].shape[0])],
         width=[int(scene.width), int(scene_d.width)], points=N_POINTS,
         surface_d_max=SURFACE_D_MAX,
         hit_fraction_surface=float((sid_s >= 0).float().mean()),
         entry_exit_points_differ=n_differ,
         brute_force=[
             check_nearest_vs_brute("nearest_random", pr_dev, sw, dw,
                                    tris_dev, 4),
             check_nearest_vs_brute("nearest_random_entry_exit", pr_dev, se,
                                    de, tris_dev, 5),
             check_nearest_vs_brute("nearest_surface_w128", ps_dev, sid_s,
                                    res["nearest_surface_w128"][1],
                                    trisd_dev, 6, d_max=SURFACE_D_MAX)])

    # ---- phase 7: nearest timings ---------------------------------------
    e2e = {}
    for leg, fn in legs.items():
        ms = cuda_ms(fn)
        e2e[leg] = {"ms": ms, "points_per_s": N_POINTS / (ms * 1e-3)}
    emit("nearest_breakdown", card=card, legs={
        leg: device_breakdown(fn, e2e[leg]["ms"]) for leg, fn in legs.items()})
    # each kernel on the legs' own sorted rows, against its plain version:
    # the bound seed, then the walks' FRAME builds, which the path launches
    # on its host scenes, on the seeded rows
    rows_r, rows_s = nearest_rows(pr_dev, ps_dev)
    t0 = time.perf_counter()
    vs_plain, seeded = {}, {}
    for leg, sc, rows in (("random", scene, rows_r),
                          ("surface_w128", scene_d, rows_s)):
        differ, seeded[leg] = seed_compare(sc, rows)
        vs_plain[f"nearest_seed/{leg}"] = {"points_differ": differ}
        check(differ == 0, f"nearest_seed/{leg}: {differ} points differ from "
                           "plain")
    runs = {"nearest_wide/random": ("wide", scene, seeded["random"]),
            "nearest_tight/random": ("entry_exit", scene, seeded["random"]),
            "nearest_wide/surface_w128": ("wide", scene_d,
                                          seeded["surface_w128"])}
    n_tris = {"random": len(tris[0]), "surface_w128": len(tris_d[0])}
    for key, (kind, sc, rows) in runs.items():
        differ, hits, e = near_compare(kind, sc, rows)
        name = key.split("/")[0]
        err[name] = max(err[name], e)
        vs_plain[key] = {"points_differ": differ, "hits": hits}
        check(differ == 0, f"{key}: {differ} points differ from plain")
    emit("nearest_kernels_vs_plain_main_path",
         seconds=time.perf_counter() - t0, runs=vs_plain,
         max_abs_err={k: err[k] for k in launches})
    kernel_ms, plain_ms, work, bounds = {}, {}, {}, {}
    for key, (kind, sc, rows) in runs.items():
        kernel_ms[key] = cuda_ms(lambda: near_kernel(kind, sc, rows))
        plain_ms[key] = cuda_ms(lambda: near_plain(kind, sc, rows), reps=3,
                                warmup=0)
        # work per point counted by the plain version on a sample of the
        # rows (each point's walk is independent of the others)
        _, _, steps, fires = near_plain(kind, sc, rows[:, ::32].contiguous(),
                                        counts=True)
        steps_pp, fires_pp = float(steps.float().mean()), float(fires.float().mean())
        wide = kind == "wide"
        ops = (N_POINTS * near_mod.walk_ops(wide, sc.width, steps_pp,
                                            fires_pp, frame=True)
               + n_tris[key.split("/")[1]] * near_mod.TRI_ONCE_OPS)
        table = sc.gnodes if wide else sc.smem_nodes
        nbytes = ((near_mod.N_ROWS * 4 + 8) * N_POINTS + table.nbytes
                  + sc.groups.nbytes + sc.a_lo.nbytes)
        bms, by = roofline(ops, nbytes)
        work[key] = {"group_tests" if wide else "node_visits": steps_pp,
                     "leaf_fires": fires_pp}
        bounds[key] = {"ops": ops, "bytes": nbytes, "bound_ms": bms,
                       "bound_by": by, "ops_ms_at_issue_rate": ops / issue * 1e3}
    # the seed on the random leg's sorted rows (it rewrites row 3 to the
    # same values on every call)
    key = "nearest_seed/random"
    gn, rows = _dev(scene.gnodes, dev), rows_r.clone()
    kernel_ms[key] = cuda_ms(lambda: near_mod.nearest_seed(gn, rows))
    plain_ms[key] = cuda_ms(lambda: near_mod.nearest_seed_plain(gn, rows),
                            reps=3, warmup=0)
    steps = near_mod.nearest_seed_plain(gn, rows_r[:, ::32].clone(),
                                        counts=True)
    steps_pp = float(steps.float().mean())
    ops = N_POINTS * near_mod.seed_ops(steps_pp)
    nbytes = (near_mod.N_ROWS * 4 + 4) * N_POINTS + scene.gnodes.nbytes
    bms, by = roofline(ops, nbytes)
    work[key] = {"group_tests": steps_pp}
    bounds[key] = {"ops": ops, "bytes": nbytes, "bound_ms": bms,
                   "bound_by": by, "ops_ms_at_issue_rate": ops / issue * 1e3}
    emit("nearest_timings", card=card, end_to_end=e2e, kernel_ms=kernel_ms,
         plain_ms=plain_ms, work_per_point=work, bounds=bounds)
    return [
        {"name": name, "route": "cuda",
         "source": "bvh_tpu_torch/csrc/nearest.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": err[name], "ms": kernel_ms[key],
         "plain_ms": plain_ms[key], "bound_ms": bounds[key]["bound_ms"],
         "bound_by": bounds[key]["bound_by"], "library_ms": None}
        for name, key, replaces in (
            ("nearest_wide", "nearest_wide/random",
             "bvh_tpu/ops/nearest.py:349"),
            ("nearest_tight", "nearest_tight/random",
             "bvh_tpu/ops/nearest.py:214"),
            ("nearest_seed", "nearest_seed/random", "none (port only)"))]


CAMERA_SIDE = 1024  # the W=128 leg's camera: pixels a side
# its eye, look-at point, up and vertical field of view
CAMERA = ([0.0, 60.0, -120.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 55.0)


def dense_camera():
    """The W=128 leg's camera rays over the dense mesh, numpy: 1024x1024
    pixels in 32x32 tiles (tile-major)."""
    side = CAMERA_SIDE
    oc, dc = camera_rays(*CAMERA, side, side)

    def tile(x):
        return (x.reshape(side // 32, 32, side // 32, 32, 3)
                .transpose(0, 2, 1, 3, 4).reshape(-1, 3).copy())

    return tile(oc), tile(dc)


def trace_rows(od, dd, mode):
    """The ray rows the group walk takes on a leg of rays ``od``, ``dd`` on
    the card: sorted with ``sort_rays_device(mode=mode)`` (None: as given),
    unbounded."""
    rays = Ray.create(od, dd)
    if mode is not None:
        rays = rays.take(sort_rays_device(od, dd, mode=mode)[0])
    return _ray_rows(rays, torch.full((od.shape[0],), float("inf"),
                                      device=od.device))


PATH_LIGHT = (40.0, 80.0, -40.0)  # the pathtrace leg's point light


def pathtracer(scene_d, tris_np, dev):
    """bench.py's pathtrace leg over the dense mesh: the renderer and its
    packet (bounces=2, packet=1024, the light at (40, 80, -40), power
    20000)."""
    packet = 1024
    return make_pathtracer(scene_d, tris_np, bounces=2, packet=packet,
                           light_pos=PATH_LIGHT, light_power=20000.0,
                           device=dev), packet


def main_rays(a):
    """The ray legs of the 120k scene (first vertices ``a``), numpy:
    bench.py's 2,097,152 random rays and its 1,048,576 aimed rays."""
    o, d = tb.create_rays(2 << 20, seed=tb.seed_state_after(10000))
    return (o, d, *tb.aimed_rays(a, 1 << 20))


def walk_bound(n: int, width: int, steps: float, fires: float, wide: bool,
               nbytes: float, n_tris: int, frame: bool = False):
    """Operations of ``n`` rays' trace walks (``steps`` group tests or node
    visits and ``fires`` narrowphased leaves per ray) over a scene of
    ``n_tris`` triangles, and the least time for them and ``nbytes``;
    ``frame``: the FRAME build's leaf tests."""
    step = (wide_mod.K * wide_mod.SLAB_OPS if wide
            else wide_mod.SLAB_OPS + tight_mod.STEP_OPS)
    leaf = wide_mod.LEAF_OPS + width * wide_mod.TRI_OPS
    if frame:
        leaf += wide_mod.FRAME_LEAF_OPS + width * wide_mod.FRAME_TRI_OPS
    ops = (n * (steps * step + fires * leaf)
           + n_tris * wide_mod.TRI_ONCE_OPS)
    bms, by = roofline(ops, nbytes)
    return {"ops": ops, "bytes": nbytes, "bound_ms": bms, "bound_by": by}


def pathtrace_phase(dev, card: str, scene_d, tris_np, oc_dev, dc_dev,
                    issue: float, err: dict) -> dict:
    """Phase 8: bench.py's pathtrace leg through make_pathtracer, its checks
    and timings. Returns the any-mode group walk's entry of the
    ``kernels`` line."""
    side = int(round(oc_dev.shape[0] ** 0.5))
    bounces, light = 2, PATH_LIGHT
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris_np)
    t0 = time.perf_counter()
    tracer, packet = pathtracer(scene_d, tris_np, dev)
    setup_s = time.perf_counter() - t0

    def frame():
        return tracer(oc_dev, dc_dev, torch.Generator(device=dev).manual_seed(0))

    # the path tracer's main path: every count is zero before and read after
    obs.reset()
    col = frame()
    torch.cuda.synchronize()
    launches = {"wide_trace": n_launched("wide_trace"),
                "wide_trace_any": n_launched("wide_trace.any"),
                "sweep_gate": n_launched("sweep")}
    emit("pathtrace_launches", **launches,
         wide_trace_frame=n_launched("wide_trace.frame"))
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the pathtrace path")
    check(n_launched("wide_trace.frame") == launches["wide_trace"],
          "a group walk of the pathtrace path did not take the FRAME build")
    check(col.shape == (side * side, 3), "pathtrace colour shape")
    check(bool(torch.isfinite(col).all()) and bool((col >= 0).all()),
          "pathtrace colours must be finite and non-negative")

    # the first wave's shadow rays, as the path tracer makes them
    v9 = torch.cat(tris_dev, dim=1)
    hit = trace_closest_hit_tight(scene_d, Ray.create(oc_dev, dc_dev),
                                  tris=tris_dev, packet=packet, device=dev)
    found, p, nrm = hit_frames(hit, oc_dev, dc_dev, v9)
    lp = torch.tensor(light, dtype=torch.float32, device=dev)
    sh_o, wl, dist_l = shadow_rays(p, nrm, found, lp)
    tmax = dist_l * 0.999
    sh_rays = Ray.create(sh_o, wl)
    occl = trace_any_hit_tight(scene_d, sh_rays, t_max=tmax, packet=packet,
                               sweep=True, device=dev)
    # the any-mode kernel against its plain version on the wave's full rows
    rows = _ray_rows(sh_rays, tmax)
    gn, grp = _dev(scene_d.gnodes, dev), _dev(scene_d.groups, dev)
    W = scene_d.width
    # the wave's sweep gate (trace_any_hit_tight's sweep=True) against its
    # plain version, then the any-mode walk gated by it as the wave runs it
    g_k = sweep_mod.sweep_gate(node_recs(scene_d.smem_nodes, dev), rows,
                               packet)
    g_p = sweep_mod.sweep_gate_plain(_dev(scene_d.smem_nodes, dev), rows,
                                     packet)
    gates_differ = int((g_k != g_p).sum())
    check(gates_differ == 0, f"pathtrace shadow wave: {gates_differ} sweep "
          "gates differ from plain")
    kw = dict(packet=packet, bounded=True, mode="any", gate=g_k,
              a_lo=a_lo_of(scene_d, dev))
    rec = records(scene_d, dev)
    tk, ik = wide_mod.wide_trace(rec, grp, rows, W, scene_d.gdepth, **kw)
    tp, ip = wide_plain_chunked(gn, grp, rows, W, **kw)
    torch.cuda.synchronize()
    differ = same_bits(tk, ik, tp, ip)
    err["wide_trace_any"] = max(err["wide_trace"], finite_err(tk, tp))
    check(differ == 0, f"pathtrace shadow wave: {differ} rays differ from plain")
    check(bool(((tk < tmax) == occl).all()),
          "trace_any_hit_tight disagrees with the any-mode kernel")
    # 4,096 sampled live shadow rays against brute-force occlusion
    live = torch.nonzero(found).flatten().cpu().numpy()
    idx = torch.from_numpy(np.random.default_rng(8).choice(
        live, N_SAMPLE, replace=False)).to(dev)
    t_bf = brute_force(sh_o[idx], wl[idx], tris_dev)
    occ_bf = t_bf < tmax[idx]
    # an occluder within the key truncation of t_max may fall either side
    band = (t_bf - tmax[idx]).abs() <= 2 * W * 2.0 ** -23 * tmax[idx]
    mism = occ_bf != occl[idx]
    n_mism, n_band = int(mism.sum()), int((mism & band).sum())
    check(n_mism == n_band, f"pathtrace shadow rays: {n_mism - n_band} of "
          f"{N_SAMPLE} sampled rays disagree with brute-force occlusion")
    emit("pathtrace", triangles=int(tris_np[0].shape[0]), width=int(W),
         pixels=side * side, bounces=bounces, packet=packet,
         setup_s=setup_s, colour_mean=[float(x) for x in col.mean(dim=0)],
         colour_max=float(col.max()),
         first_wave={"hit_fraction": float(found.float().mean()),
                     "occluded_fraction_of_hits": float(
                         (occl & found).float().sum() / found.float().sum()),
                     "kernel_vs_plain_rays_differ": differ,
                     "sweep_gate_vs_plain": {"gates_differ": gates_differ,
                                             "gates_open": int(g_k.sum()),
                                             "gates": g_k.numel()},
                     "brute_force": {"sampled": N_SAMPLE,
                                     "mismatches": n_mism,
                                     "in_t_max_band": n_band,
                                     "agreement": 1.0 - n_mism / N_SAMPLE}})

    ms = cuda_ms(frame, reps=5)
    rays = side * side * 2 * (bounces + 1)
    bd = device_breakdown(frame, ms)
    kms = cuda_ms(lambda: wide_mod.wide_trace(rec, grp, rows, W,
                                              scene_d.gdepth, **kw))
    pms = cuda_ms(lambda: wide_plain_chunked(gn, grp, rows, W, **kw), reps=3,
                  warmup=0)
    # work per ray on every 32nd ray: sample ray j lies in packet
    # 32j // packet, so the gate applies to it at packet // 32
    _, _, tests, fires = wide_mod.wide_trace_plain(
        gn, grp, rows[:, ::32].contiguous(), W, counts=True,
        **{**kw, "packet": packet // 32})
    tests_pr, fires_pr = float(tests.float().mean()), float(fires.float().mean())
    n = rows.shape[1]
    b = walk_bound(n, W, tests_pr, fires_pr, True,
                   wide_mod.N_ROWS * 4 * n + rec.nbytes
                   + scene_d.groups.nbytes + scene_d.a_lo.nbytes + 8 * n,
                   len(tris_np[0]), frame=True)
    emit("pathtrace_timings", card=card, ms=ms, rays_per_s=rays / (ms * 1e-3),
         rays_counted=rays, breakdown=bd,
         wide_trace_any={"ms": kms, "plain_ms": pms, "group_tests": tests_pr,
                         "leaf_fires": fires_pr,
                         "ops_ms_at_issue_rate": b["ops"] / issue * 1e3, **b})
    return {"name": "wide_trace_any", "route": "cuda",
            "source": "bvh_tpu_torch/csrc/wide_trace.cu",
            "replaces": "bvh_tpu/ops/trace.py:1178",
            "launches": launches["wide_trace_any"],
            "max_abs_err": err["wide_trace_any"], "ms": kms, "plain_ms": pms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None}


def classify_differences(h_a, h_b, W: int, crack=None) -> tuple[list, int]:
    """Rays whose t bits or shape ids differ between two traces of the same
    rays, each classed "near-tie" (exact t within one key step, 2W ulps),
    "grazing-edge" (t within 3e-3, PARITY.md) or, where ``crack`` (bool per
    ray) is True and one trace misses, "crack" (the grazing-edge class
    through a crack at an edge); returns the list and the count outside
    every class."""
    t_a, t_b = h_a.t.cpu().numpy(), h_b.t.cpu().numpy()
    s_a, s_b = h_a.shape_id.cpu().numpy(), h_b.shape_id.cpu().numpy()
    idx = np.nonzero((t_a.view(np.int32) != t_b.view(np.int32)) | (s_a != s_b))[0]
    check(len(idx) <= 10000, f"{len(idx)} rays differ between the two walks")
    out, outside = [], 0
    for i in idx.tolist():
        ta, tb_ = float(t_a[i]), float(t_b[i])
        both = np.isfinite(ta) and np.isfinite(tb_)
        rel = abs(ta - tb_) / max(abs(ta), 1e-30) if both else np.inf
        cls = ("near-tie" if rel <= 2 * W * 2.0 ** -23 else
               "grazing-edge" if rel <= 3e-3 else
               "crack" if crack is not None and crack[i] else "outside")
        outside += cls == "outside"
        out.append({"ray": i, "t": [ta, tb_],
                    "shape_id": [int(s_a[i]), int(s_b[i])], "class": cls})
    return out, outside


def entry_exit_phase(dev, card: str, scene_w, tris_np, ao, ad, ao_dev, ad_dev,
                     o_dev, d_dev, h_aim, issue: float, err: dict) -> list:
    """Phase 9: the entry/exit legs on the 120k scene (wide=False and
    packed=True builds through make_tracer; any hit on the wide and the
    wide=False scene; the broadphase-only walk, skip_narrow, on the aimed
    and the sorted reference rays), their checks and timings. Returns the
    entry/exit kernel's and its SKIP build's entries of the ``kernels``
    line."""
    a, b, c = tris_np
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris_np)
    n = ao.shape[0]
    t0 = time.perf_counter()
    scene_nw = build_tight_scene(a, b, c, wide=False)
    t1 = time.perf_counter()
    scene_pk = build_tight_scene(a, b, c, packed=True)
    build_s = {"wide_false": t1 - t0, "packed": time.perf_counter() - t1}
    check(scene_nw.gnodes is None and scene_pk.packed_nodes is not None
          and scene_pk.gnodes is None, "entry/exit scene layouts")
    tr_nw = make_tracer(scene_nw, packet=8192, sort="morton", tris=tris_np)
    tr_pk = make_tracer(scene_pk, packet=8192, sort="morton", tris=tris_np)
    perm, inv = sort_rays_device(ao_dev, ad_dev, mode="morton")
    perm_r, _ = sort_rays_device(o_dev, d_dev, mode="octmorton")
    rays_r = Ray.create(o_dev, d_dev).take(perm_r)  # the sorted reference rays
    t_hit = h_aim.t

    def shadow(sc, factor):
        return trace_any_hit_tight(sc, Ray.create(ao_dev, ad_dev),
                                   t_max=t_hit * factor, packet=8192,
                                   perm=perm)[inv]

    legs = {
        "aimed_entry_exit": lambda: tr_nw(ao_dev, ad_dev),
        "aimed_packed": lambda: tr_pk(ao_dev, ad_dev),
        "shadow_aimed": lambda: shadow(scene_w, 1.2),
        "shadow_aimed_entry_exit": lambda: shadow(scene_nw, 1.2),
        # the broadphase-only walk (no leaf test: every ray a miss)
        "skip_narrow_aimed": lambda: trace_closest_hit_tight(
            scene_nw, Ray.create(ao_dev, ad_dev), packet=8192, perm=perm,
            skip_narrow=True),
        "skip_narrow_random": lambda: trace_closest_hit_tight(
            scene_nw, rays_r, packet=8192, skip_narrow=True),
    }
    # the entry/exit main path: every count is zero before and read after
    obs.reset()
    res = {leg: fn() for leg, fn in legs.items()}
    torch.cuda.synchronize()
    launches = {"tight_trace": n_launched("tight_trace"),
                "tight_trace_any": n_launched("tight_trace.any"),
                "tight_trace_skip": n_launched("tight_trace.skip"),
                "wide_trace_any": n_launched("wide_trace.any"),
                "sweep_gate": n_launched("sweep")}
    emit("entry_exit_launches", **launches,
         tight_trace_frame=n_launched("tight_trace.frame"),
         wide_trace_frame=n_launched("wide_trace.frame"))
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the entry/exit path")
    # host builds carry a_lo: every walk of the path with a leaf test is a
    # FRAME launch (the SKIP build has none, and takes no table)
    check(n_launched("tight_trace.frame")
          == launches["tight_trace"] - launches["tight_trace_skip"]
          and n_launched("wide_trace.frame") == n_launched("wide_trace"),
          "a walk of the entry/exit path did not take the FRAME build")
    s08 = [shadow(scene_w, 0.8), shadow(scene_nw, 0.8)]

    diffs, outside = classify_differences(h_aim, res["aimed_entry_exit"],
                                          scene_nw.width)
    check(outside == 0, f"aimed_entry_exit differs from the wide aimed leg on "
          f"{outside} rays outside the near-tie and grazing-edge classes")
    h_pk = res["aimed_packed"]
    hit_pk = float(torch.isfinite(h_pk.t).float().mean())
    check(hit_pk >= 0.999, f"aimed_packed hit fraction {hit_pk} < 0.999")
    bf_pk = check_vs_brute("aimed_packed", ao, ad, h_pk.t.cpu().numpy(),
                           tris_dev, 7)
    s_w, s_nw = res["shadow_aimed"], res["shadow_aimed_entry_exit"]
    check(s_w.dtype == torch.bool and s_w.shape == (n,), "shadow output")
    check(bool((s_w == s_nw).all()),
          "shadow_aimed differs between the wide and the wide=False scene")
    check(not bool(s08[0].any()) and not bool(s08[1].any()),
          "a shadow ray is occluded below 0.8x its closest hit")
    idx = np.random.default_rng(9).choice(n, N_SAMPLE, replace=False)
    idx_d = torch.from_numpy(idx).to(dev)
    occ_bf = brute_force(ao[idx], ad[idx], tris_dev) < t_hit[idx_d] * 1.2
    sh_mism = int((occ_bf != s_w[idx_d]).sum())
    check(sh_mism == 0, f"shadow_aimed: {sh_mism} sampled rays disagree with "
          "brute-force occlusion")
    skip_res = {}
    for leg in ("skip_narrow_aimed", "skip_narrow_random"):
        h = res[leg]
        miss = (bool(torch.isinf(h.t).all()) and bool((h.t > 0).all())
                and bool((h.shape_id == -1).all())
                and not bool(h.u.any()) and not bool(h.v.any()))
        skip_res[leg] = {"rays": int(h.t.shape[0]), "all_miss": miss}
        check(miss, f"{leg}: a ray of the broadphase-only walk hit")
    emit("entry_exit", triangles=int(a.shape[0]), rays=n, build_s=build_s,
         nodes=int(scene_nw.smem_nodes.shape[1]),
         aimed_entry_exit={"rays_differ_from_wide": len(diffs),
                           "differences": diffs[:64]},
         aimed_packed={"hit_fraction": hit_pk, "brute_force": bf_pk},
         shadow_aimed={"occluded_fraction": float(s_w.float().mean()),
                       "wide_equals_entry_exit": True,
                       "all_clear_at_0_8": True,
                       "brute_force": {"sampled": N_SAMPLE,
                                       "mismatches": sh_mism}},
         skip_narrow=skip_res)

    e2e = {}
    for leg, fn in legs.items():
        ms = cuda_ms(fn)
        e2e[leg] = {"ms": ms, "rays_per_s": n / (ms * 1e-3)}
    emit("entry_exit_breakdown", card=card, legs={
        leg: device_breakdown(fn, e2e[leg]["ms"]) for leg, fn in legs.items()})

    # the kernel on the legs' own sorted rows, against its plain version
    rays_s = Ray.create(ao_dev, ad_dev).take(perm)
    inf = torch.full((n,), float("inf"), device=dev)
    rows = _ray_rows(rays_s, inf)
    rows_sh = _ray_rows(rays_s, (t_hit * 1.2)[perm])
    W = scene_nw.width
    t0 = time.perf_counter()
    # the sweep gate of each aimed leg (make_tracer's sweep=True), on the
    # leg's own rows and table, against its plain version
    gates, vs_plain = {}, {}
    for leg, table, packed in (
            ("aimed_entry_exit", scene_nw.smem_nodes, False),
            ("aimed_packed", scene_pk.packed_nodes, True)):
        g_k = sweep_mod.sweep_gate(node_recs(table, dev), rows, 8192,
                                   packed=packed)
        g_p = sweep_mod.sweep_gate_plain(_dev(table, dev), rows, 8192,
                                         packed=packed)
        bad = int((g_k != g_p).sum())
        vs_plain[f"sweep_gate/{leg}"] = {"gates_differ": bad,
                                         "gates_open": int(g_k.sum()),
                                         "gates": g_k.numel()}
        check(bad == 0, f"{leg}: {bad} sweep gates differ from plain")
        gates[leg] = g_k
    # the FRAME builds, which the path launches on its host scenes
    alo_nw, alo_pk = a_lo_of(scene_nw, dev), a_lo_of(scene_pk, dev)
    runs = {
        "aimed_entry_exit": (scene_nw.smem_nodes, scene_nw.groups, rows,
                             {"gate": gates["aimed_entry_exit"],
                              "a_lo": alo_nw}),
        "aimed_packed": (scene_pk.packed_nodes, scene_pk.groups, rows,
                         {"packed": True, "gate": gates["aimed_packed"],
                          "a_lo": alo_pk}),
        "shadow_aimed_entry_exit": (scene_nw.smem_nodes, scene_nw.groups,
                                    rows_sh, {"mode": "any", "bounded": True,
                                              "a_lo": alo_nw}),
    }
    kernel_ms, plain_ms, work = {}, {}, {}
    err["tight_trace"] = err.get("tight_trace", 0.0)
    for leg, (table, groups, rr, kw) in runs.items():
        tab, grp = _dev(table, dev), _dev(groups, dev)
        tk, ik = tight_mod.tight_trace(node_recs(table, dev), grp, rr, W,
                                       packet=8192, **kw)
        tp, ip = tight_plain_chunked(tab, grp, rr, W, **kw)
        torch.cuda.synchronize()
        differ = same_bits(tk, ik, tp, ip)
        err["tight_trace"] = max(err["tight_trace"], finite_err(tk, tp))
        vs_plain[leg] = {"rays_differ": differ, "hits": int((ik >= 0).sum())}
        check(differ == 0, f"{leg}: {differ} rays differ from plain")
    vs_s = time.perf_counter() - t0
    # the sweep gate on each aimed leg's table, timed on the leg's rows
    sweep_ms, sweep_plain_ms, sweep_bounds = {}, {}, {}
    for leg, table, packed in (
            ("aimed_entry_exit", scene_nw.smem_nodes, False),
            ("aimed_packed", scene_pk.packed_nodes, True)):
        tab, rec = _dev(table, dev), node_recs(table, dev)
        sweep_ms[leg] = cuda_ms(lambda: sweep_mod.sweep_gate(
            rec, rows, 8192, packed=packed))
        sweep_plain_ms[leg] = cuda_ms(lambda: sweep_mod.sweep_gate_plain(
            tab, rows, 8192, packed=packed), reps=3, warmup=0)
        sweep_bounds[leg] = sweep_bound(tab, rows, 8192, packed=packed)
    bounds = {}
    for leg, (table, groups, rr, kw) in runs.items():
        tab, grp = _dev(table, dev), _dev(groups, dev)
        rec = node_recs(table, dev)
        kernel_ms[leg] = cuda_ms(lambda: tight_mod.tight_trace(
            rec, grp, rr, W, packet=8192, **kw))
        plain_ms[leg] = cuda_ms(lambda: tight_plain_chunked(tab, grp, rr, W,
                                                            **kw),
                                reps=3, warmup=0)
        # every 32nd ray; its gate applies at packet 8192 // 32
        _, _, visits, fires = tight_mod.tight_trace_plain(
            tab, grp, rr[:, ::32].contiguous(), W, counts=True,
            packet=8192 // 32, **kw)
        v_pr, f_pr = float(visits.float().mean()), float(fires.float().mean())
        work[leg] = {"node_visits": v_pr, "leaf_fires": f_pr}
        b = walk_bound(n, W, v_pr, f_pr, False,
                       wide_mod.N_ROWS * 4 * n + table.nbytes + groups.nbytes
                       + kw["a_lo"].nbytes + 8 * n, len(tris_np[0]),
                       frame=True)
        bounds[leg] = {**b, "ops_ms_at_issue_rate": b["ops"] / issue * 1e3}
    # the SKIP build: against its plain version on the aimed and the
    # reference rows (ungated, unbounded), timed in turns beside the full
    # walk on the same rows; the full walk's ms less the SKIP build's is
    # the walk's leaf-test time
    rec_nw, grp_nw = node_recs(scene_nw.smem_nodes, dev), _dev(scene_nw.groups,
                                                              dev)
    tab_nw = _dev(scene_nw.smem_nodes, dev)
    rows_r = _ray_rows(rays_r, torch.full((rays_r.origin.shape[0],),
                                          float("inf"), device=dev))
    skip_rows = {"aimed": rows, "random": rows_r}
    skip_turns, skip_plain_ms, skip_work, skip_bounds = {}, {}, {}, {}
    for leg, rr in skip_rows.items():
        tk, ik = tight_mod.tight_trace(rec_nw, grp_nw, rr, W, packet=8192,
                                       skip_narrow=True)
        tp, ip = tight_plain_chunked(tab_nw, grp_nw, rr, W, skip_narrow=True)
        torch.cuda.synchronize()
        differ = same_bits(tk, ik, tp, ip)
        vs_plain[f"skip/{leg}"] = {"rays_differ": differ,
                                   "hits": int((ik >= 0).sum())}
        check(differ == 0 and bool(torch.isinf(tk).all()),
              f"skip/{leg}: {differ} rays differ from plain")
        turns = in_turns({
            "full": lambda rr=rr: tight_mod.tight_trace(rec_nw, grp_nw, rr, W,
                                                        packet=8192,
                                                        a_lo=alo_nw),
            "skip": lambda rr=rr: tight_mod.tight_trace(
                rec_nw, grp_nw, rr, W, packet=8192, skip_narrow=True)})
        turns["leaf_test_ms"] = turns["full"]["ms"] - turns["skip"]["ms"]
        turns["leaf_test_share"] = turns["leaf_test_ms"] / turns["full"]["ms"]
        skip_turns[leg] = turns
        if leg == "aimed":
            skip_plain_ms[leg] = cuda_ms(lambda rr=rr: tight_plain_chunked(
                tab_nw, grp_nw, rr, W, skip_narrow=True), reps=3, warmup=0)
        # node visits of every 32nd ray's walk, with and without leaf tests
        sample = rr[:, ::32].contiguous()
        _, _, v_s, _ = tight_mod.tight_trace_plain(tab_nw, grp_nw, sample, W,
                                                   counts=True,
                                                   skip_narrow=True)
        _, _, v_f, f_f = tight_mod.tight_trace_plain(tab_nw, grp_nw, sample,
                                                     W, counts=True,
                                                     a_lo=alo_nw)
        m = rr.shape[1]
        v_pr = float(v_s.float().mean())
        skip_work[leg] = {"node_visits_skip": v_pr,
                          "node_visits_full": float(v_f.float().mean()),
                          "leaf_fires_full": float(f_f.float().mean())}
        # the SKIP build's least work: its slab tests and cursor moves, the
        # rows and the node records read once, the outputs written once
        ops = m * v_pr * (wide_mod.SLAB_OPS + tight_mod.STEP_OPS)
        nbytes = wide_mod.N_ROWS * 4 * m + rec_nw.nbytes + 8 * m
        bms, by = roofline(ops, nbytes)
        skip_bounds[leg] = {"ops": ops, "bytes": nbytes, "bound_ms": bms,
                            "bound_by": by,
                            "ops_ms_at_issue_rate": ops / issue * 1e3}
    emit("entry_exit_timings", card=card, end_to_end=e2e,
         kernels_vs_plain={"seconds": vs_s, "runs": vs_plain},
         kernel_ms=kernel_ms, plain_ms=plain_ms, work_per_ray=work,
         bounds=bounds, sweep_gate={"ms": sweep_ms, "plain_ms": sweep_plain_ms,
                                    "bounds": sweep_bounds},
         skip_narrow={"in_turns": skip_turns, "plain_ms": skip_plain_ms,
                      "work_per_ray": skip_work, "bounds": skip_bounds})
    key = "aimed_entry_exit"
    return [{"name": "tight_trace", "route": "cuda",
             "source": "bvh_tpu_torch/csrc/tight_trace.cu",
             "replaces": "bvh_tpu/ops/trace.py:650",
             "launches": launches["tight_trace"],
             "max_abs_err": err["tight_trace"], "ms": kernel_ms[key],
             "plain_ms": plain_ms[key], "bound_ms": bounds[key]["bound_ms"],
             "bound_by": bounds[key]["bound_by"], "library_ms": None},
            {"name": "tight_trace_skip", "route": "cuda",
             "source": "bvh_tpu_torch/csrc/tight_trace.cu",
             "replaces": "bvh_tpu/ops/trace.py:740",
             "launches": launches["tight_trace_skip"], "max_abs_err": 0.0,
             "ms": skip_turns["aimed"]["skip"]["ms"],
             "plain_ms": skip_plain_ms["aimed"],
             "bound_ms": skip_bounds["aimed"]["bound_ms"],
             "bound_by": skip_bounds["aimed"]["bound_by"],
             "library_ms": None}]


def in_turns(fns: dict, rounds: int = 2) -> dict:
    """Each of ``fns`` timed with ``cuda_ms`` in turns, in the given order
    and then back (A B B A), ``rounds`` times: the median of its turns and
    the turns."""
    turns = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for k in order:
            turns[k].append(cuda_ms(fns[k]))
    return {k: {"ms": statistics.median(v), "turns": v}
            for k, v in turns.items()}


def records_equal(h_a, h_b) -> bool:
    """Two HitRecords equal bit for bit in every field."""
    return all(torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)
               for x, y in zip(h_a, h_b))


def plain_walk_on_card(records_, groups, rows, width, depth, **kw):
    """``wide_mod.wide_trace``'s signature over the plain group walk on the
    same tensors (chunked): the diff leg's plain-walk twin."""
    return wide_plain_chunked(wide_mod.wide_table(records_), groups, rows,
                              width, **kw)


def planned_phase(dev, card: str, scene, tris_np, ao, ad, ao_dev, ad_dev,
                  h_aim, issue: float, err: dict) -> dict:
    """Phase 12: bench.py's aimed and diff_fwd_bwd legs as the reference
    runs them, with the key planner's subtree entries (``start_g``); the
    sampling planner and the seeded trace; checks and timings. Returns the
    entry of the group walk with subtree entries in the ``kernels`` line."""
    a = tris_np[0]
    n, packet, W = ao.shape[0], 8192, scene.width
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris_np)
    tracers = {(plan, sweep): make_tracer(scene, packet=packet, sweep=sweep,
                                          sort="morton", tris=tris_np,
                                          plan=plan)
               for plan in (None, "key") for sweep in (True, False)}
    tr_key = tracers["key", True]
    # bench.py's aimed leg: the morton-sorted rays and their packets' plan
    perm, _ = sort_rays_device(ao_dev, ad_dev, mode="morton")
    aimed = Ray.create(ao_dev[perm], ad_dev[perm])
    key_plan = make_key_planner(scene, packet=packet)
    sg_key = key_plan(aimed.origin)
    target = torch.zeros(n, dtype=torch.float32, device=dev)

    def fwd_bwd():
        """bench.py's diff_fwd_bwd: the loss over the hits and its gradients
        with respect to a, b and c."""
        av, bv, cv = (x.detach().requires_grad_() for x in tris_dev)
        depth, hit = render_depth_fast(scene, aimed, av, bv, cv,
                                       packet=packet, start_g=sg_key)
        loss = torch.where(hit, (depth - target) ** 2, 0.0).sum() * 1e-9
        loss.backward()
        return loss.detach(), depth.detach(), hit, (av.grad, bv.grad, cv.grad)

    # the phase's main path: every count is zero before and read after
    obs.reset()
    h_key = tr_key(ao_dev, ad_dev)
    diff_out = fwd_bwd()
    torch.cuda.synchronize()
    launches = {"wide_trace": n_launched("wide_trace"),
                "wide_trace_subtree": n_launched("wide_trace.subtree"),
                "sweep_gate": n_launched("sweep")}
    emit("planned_launches", **launches,
         wide_trace_frame=n_launched("wide_trace.frame"))
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the planned aimed and "
              "diff_fwd_bwd path")
    check(n_launched("wide_trace.frame") == launches["wide_trace"],
          "a group walk of the planned path did not take the FRAME build")

    # the planned leg equals the unplanned one and holds brute force's bounds
    check(records_equal(h_key, h_aim),
          "the key-planned aimed leg differs from the unplanned one")
    bf_key = check_vs_brute("aimed_key", ao, ad, h_key.t.cpu().numpy(),
                            tris_dev, 12)
    # the sampling planner, the device seeder and the seeded trace
    base = trace_closest_hit_tight(scene, aimed, packet=packet)
    seeded = trace_closest_hit_seeded(scene, aimed, packet=packet)
    hints_p, sg_plan = make_planner(scene, packet=packet)(aimed)
    planned = trace_closest_hit_tight(scene, aimed, packet=packet,
                                      hints=hints_p, start_g=sg_plan)
    check(records_equal(seeded, base), "the seeded trace differs from the "
          "unseeded one")
    check(records_equal(planned, base), "the sampling planner's trace "
          "differs from the unplanned one")
    check(records_equal(trace_closest_hit_tight(scene, aimed, packet=packet,
                                                start_g=sg_key), base),
          "trace_closest_hit_tight(start_g=) differs from the unplanned trace")
    plans = {"key": {"packets": int(sg_key.shape[0]),
                     "first_entries": int((sg_key[:, 0] > 0).sum()),
                     "second_entries": int((sg_key[:, 1] > 0).sum())},
             "sampling": {"first_entries": int((sg_plan[:, 0] > 0).sum()),
                          "second_entries": int((sg_plan[:, 1] > 0).sum())}}

    # diff_fwd_bwd: depth against brute force, gradients against the same
    # loss with the plain walk as the hard pass on the card
    loss, depth, hit, grads = diff_out
    t_depth = torch.where(hit, depth, float("inf")).cpu().numpy()
    bf_diff = check_vs_brute("diff_fwd_bwd", ao[perm.cpu().numpy()],
                             ad[perm.cpu().numpy()], t_depth, tris_dev, 13)
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "diff_fwd_bwd: a gradient is not finite")
    orig = trace_mod.wide_trace
    trace_mod.wide_trace = plain_walk_on_card
    try:
        loss_p, depth_p, hit_p, grads_p = fwd_bwd()
    finally:
        trace_mod.wide_trace = orig
    check(torch.equal(hit, hit_p) and torch.equal(
        depth.view(torch.int32), depth_p.view(torch.int32)),
        "diff_fwd_bwd: depth differs from the plain-walk twin")
    grad_err = []
    for g, gp in zip(grads, grads_p):
        scale = float(gp.abs().max())
        e = float((g - gp).abs().max())
        grad_err.append({"max_abs_diff": e, "max_abs": scale})
        check(e <= DIFF_GRAD_RTOL * scale, f"diff_fwd_bwd: gradients differ "
              f"from the plain-walk twin by {e} (largest {scale})")
    emit("planned", triangles=int(a.shape[0]), rays=n, packet=packet,
         plans=plans, aimed_key_equals_unplanned=True, brute_force=bf_key,
         seeded_equals_unseeded=True, sampling_planner_equals_unplanned=True,
         diff_fwd_bwd={"loss": float(loss), "loss_plain_twin": float(loss_p),
                       "hit_fraction": float(hit.float().mean()),
                       "brute_force": bf_diff,
                       "gradients_vs_plain_twin": grad_err,
                       "grad_rtol": DIFF_GRAD_RTOL})

    # planned and unplanned tracers timed in turns (host time moves between
    # calls and phases)
    e2e = in_turns({
        f"aimed_plan_{plan}_sweep_{'on' if sweep else 'off'}":
        (lambda tr=tr: tr(ao_dev, ad_dev))
        for (plan, sweep), tr in tracers.items()})
    for v in e2e.values():
        v["rays_per_s"] = n / (v["ms"] * 1e-3)

    def hard_pass():
        with torch.no_grad():
            return trace_closest_hit_tight(scene, aimed, packet=packet,
                                           start_g=sg_key)

    def forward():
        av, bv, cv = (x.detach().requires_grad_() for x in tris_dev)
        depth, hit = render_depth_fast(scene, aimed, av, bv, cv,
                                       packet=packet, start_g=sg_key)
        return torch.where(hit, (depth - target) ** 2, 0.0).sum() * 1e-9

    # diff_fwd_bwd and its parts, each timed alone: the hard pass, the
    # forward (hard pass, gather, recompute, loss), forward and backward
    parts = {k: cuda_ms(fn, reps=5) for k, fn in
             (("hard_pass", hard_pass), ("forward", forward),
              ("forward_backward", fwd_bwd))}
    ms = parts["forward_backward"]
    e2e["diff_fwd_bwd"] = {"ms": ms, "rays_per_s": n / (ms * 1e-3),
                           "parts_ms": {
                               "hard_pass": parts["hard_pass"],
                               "gather_recompute_loss":
                               parts["forward"] - parts["hard_pass"],
                               "backward": ms - parts["forward"]}}
    legs = {"aimed_plan_key_sweep_on": lambda: tr_key(ao_dev, ad_dev),
            "diff_fwd_bwd": fwd_bwd}
    emit("planned_breakdown", card=card, legs={
        leg: device_breakdown(fn, e2e[leg]["ms"]) for leg, fn in legs.items()})

    # row 1 with subtree entries on the leg's own sorted rows, gated as
    # make_tracer's sweep=True gates them, against its plain version
    rows = _ray_rows(aimed, torch.full((n,), float("inf"), device=dev))
    gate = sweep_mod.sweep_gate(node_recs(scene.smem_nodes, dev), rows, packet)
    rec, grp = records(scene, dev), _dev(scene.groups, dev)
    gn = _dev(scene.gnodes, dev)
    # the FRAME builds, which the path launches on the host scene
    alo = a_lo_of(scene, dev)
    runs = {"none_gated": {"gate": gate, "a_lo": alo},
            "key_gated": {"gate": gate, "start_g": sg_key, "a_lo": alo},
            "sampling_gated": {"gate": gate, "hints": hints_p,
                               "start_g": sg_plan, "a_lo": alo},
            "none": {"a_lo": alo}, "key": {"start_g": sg_key, "a_lo": alo}}
    vs_plain = {}
    err["wide_trace_subtree"] = 0.0
    t0 = time.perf_counter()
    for run, kw in runs.items():
        tk, ik = wide_mod.wide_trace(rec, grp, rows, W, scene.gdepth,
                                     packet=packet, **kw)
        t0k, i0k = wide_mod.wide_trace(rec, grp, rows, W, scene.gdepth,
                                       packet=packet, gate=kw.get("gate"),
                                       a_lo=alo)
        tp, ip = wide_plain_chunked(gn, grp, rows, W, packet=packet, **kw)
        torch.cuda.synchronize()
        differ = same_bits(tk, ik, tp, ip)
        vs_unplanned = same_bits(tk, ik, t0k, i0k)
        err["wide_trace_subtree"] = max(err["wide_trace_subtree"],
                                        finite_err(tk, tp))
        vs_plain[run] = {"rays_differ": differ,
                         "rays_differ_from_no_entries": vs_unplanned,
                         "hits": int((ik >= 0).sum())}
        check(differ == 0, f"planned/{run}: {differ} rays differ from plain")
        check(vs_unplanned == 0, f"planned/{run}: {vs_unplanned} rays differ "
              "from the walk without subtree entries")
    vs_s = time.perf_counter() - t0
    kernel_ms = in_turns({run: (lambda kw=kw: wide_mod.wide_trace(
        rec, grp, rows, W, scene.gdepth, packet=packet, **kw))
        for run, kw in runs.items()})
    plain_ms = {run: cuda_ms(lambda: wide_plain_chunked(
        gn, grp, rows, W, packet=packet, **runs[run]), reps=3, warmup=0)
        for run in ("none_gated", "key_gated")}
    # work per ray on every 32nd ray (its gate, hints and entries apply at
    # packet // 32), and the bound of each run from it
    work, bounds = {}, {}
    for run, kw in runs.items():
        _, _, tests, fires = wide_mod.wide_trace_plain(
            gn, grp, rows[:, ::32].contiguous(), W, counts=True,
            packet=packet // 32, **kw)
        t_pr, f_pr = float(tests.float().mean()), float(fires.float().mean())
        work[run] = {"group_tests": t_pr, "leaf_fires": f_pr}
        nbytes = (wide_mod.N_ROWS * 4 * n + rec.nbytes + scene.groups.nbytes
                  + 8 * n + sum(v.nbytes for v in kw.values()))
        b = walk_bound(n, W, t_pr, f_pr, True, nbytes, len(a), frame=True)
        bounds[run] = {**b, "ops_ms_at_issue_rate": b["ops"] / issue * 1e3}
    emit("planned_timings", card=card, end_to_end=e2e,
         kernels_vs_plain={"seconds": vs_s, "runs": vs_plain},
         kernel_ms=kernel_ms, plain_ms=plain_ms, work_per_ray=work,
         bounds=bounds)
    key = "key_gated"
    return {"name": "wide_trace_subtree", "route": "cuda",
            "source": "bvh_tpu_torch/csrc/wide_trace.cu",
            "replaces": "bvh_tpu/ops/trace.py:1468",
            "launches": launches["wide_trace_subtree"],
            "max_abs_err": err["wide_trace_subtree"],
            "ms": kernel_ms[key]["ms"],
            "plain_ms": plain_ms[key], "bound_ms": bounds[key]["bound_ms"],
            "bound_by": bounds[key]["bound_by"], "library_ms": None}


def phase_legacy_kernels(dev, n: int = 65536) -> dict:
    """Phase 2, slice 4: the legacy cluster kernel against its plain version
    on 65,536 random and 65,536 aimed rays of create_n_cubes(1000), each
    sorted with sort_rays and unsorted, on the relative and the
    global-frame scene and broadphase only (skip_narrow). Results must
    agree bit for bit."""
    a, b, c = tb.create_n_cubes(1000)
    scenes = {rel: build_cluster_scene(a, b, c, relative=rel)
              for rel in (True, False)}
    o, d = tb.create_rays(n, seed=tb.seed_state_after(1000))
    ao, ad = tb.aimed_rays(a, n)
    out, err = {}, 0.0
    for leg, (lo, ld) in {"random": (o, d), "aimed": (ao, ad),
                          "random_unsorted": (o, d),
                          "aimed_unsorted": (ao, ad)}.items():
        perm = (np.random.default_rng(11).permutation(n)
                if leg.endswith("unsorted") else sort_rays(lo, ld)[0])
        rows = ct_mod.ray_rows(Ray.create(lo[perm], ld[perm], device=dev))
        res = {}
        for case, (rel, skip) in {"relative": (True, False),
                                  "global": (False, False),
                                  "skip_narrow": (True, True)}.items():
            sc = scenes[rel]
            tk, ik = legacy_call(ct_mod.cluster_trace, sc, rows, relative=rel,
                                 skip_narrow=skip)
            tp, ip = legacy_call(ct_mod.cluster_trace_plain, sc, rows,
                                 relative=rel, skip_narrow=skip)
            torch.cuda.synchronize()
            differ = same_bits(tk, ik, tp, ip)
            err = max(err, finite_err(tk, tp))
            res[f"{case}_rays_differ"] = differ
            res[f"{case}_hits"] = int((ik >= 0).sum())
            check(differ == 0, f"legacy {leg}/{case}: {differ} rays differ "
                  "from plain")
        check(res["skip_narrow_hits"] == 0, "skip_narrow reported a hit")
        out[leg] = res
    return {"legs": out, "max_abs_err": {"cluster_trace": err}, "rays": n,
            "triangles": int(a.shape[0]),
            "clusters": int(scenes[True].num_clusters)}


def legacy_call(fn, sc, rows, **kw):
    """``fn`` (``cluster_trace`` or its plain version) over a ClusterScene's
    tables on the rows' device, its ``a_lo`` included."""
    dev = rows.device
    return fn(_dev(sc.smem_nodes, dev), _dev(sc.smem_cc, dev),
              _dev(sc.tris_rel, dev), _dev(sc.a_lo, dev), rows, **kw)


def records(sc, dev):
    """A scene's wide table in the group-walk kernel's layout, on
    ``dev``."""
    return _dev(sc.gnodes, dev, wide_mod.group_records)


def node_recs(table, dev):
    """An entry/exit table in the sweep and entry/exit kernels' layout, on
    ``dev``."""
    return _dev(table, dev, sweep_mod.node_records)


def sweep_bound(table, rows, packet: int, packed: bool = False) -> dict:
    """The sweep gate's bound on ``rows`` over the node ``table`` (on the
    rows' device): the least work that any schedule must do
    (``sweep.least_node_tests``: for a packet that fires, the shortest walk
    to a fire among its rays; for one that does not, every ray's whole
    walk; the rows 0-6 of the rays of unfired packets, the table once and
    the gate), counted by the plain walk on every ray; and, as
    ``earlier``, the bound before it, which charged every ray's walk to its
    own fire and every ray's rows."""
    n = rows.shape[1]
    fired, visits = sweep_mod.sweep_gate_plain(table, rows, 1, counts=True,
                                               packed=packed)
    tests, open_rays = sweep_mod.least_node_tests(visits, fired, packet)
    gate_bytes = 4 * (-(-n // packet))
    ops = tests * wide_mod.SLAB_OPS
    nbytes = 7 * 4 * open_rays + table.nbytes + gate_bytes
    ms, by = roofline(ops, nbytes)
    tests_0 = int(visits.sum())
    ms_0, by_0 = roofline(tests_0 * wide_mod.SLAB_OPS,
                          7 * 4 * n + table.nbytes + gate_bytes)
    return {"node_tests": tests, "rays_read": open_rays, "ops": ops,
            "bytes": nbytes, "bound_ms": ms, "bound_by": by,
            "earlier": {"node_tests": tests_0, "bound_ms": ms_0,
                        "bound_by": by_0}}


def sort_legacy(o, d, dev):
    """A legacy leg's rays sorted on the host with sort_rays: the sorted
    numpy (o, d), the same on ``dev``, the inverse permutation and the
    sort's seconds."""
    t0 = time.perf_counter()
    perm, unsort = sort_rays(o, d)
    seconds = time.perf_counter() - t0
    sorted_np = (o[perm], d[perm])
    return (sorted_np, tuple(torch.from_numpy(x).to(dev) for x in sorted_np),
            unsort, seconds)


def legacy_phase(dev, card: str, tris_np, o, d, ao, ad, h_aim, issue: float,
                 err: dict) -> dict:
    """Phase 10: the legacy ClusterScene path at full size (the 120k
    scene, relative frame): legacy_random (the 2,097,152 reference rays)
    and legacy_aimed (the 1,048,576 aimed rays with the exact recompute),
    each sorted on the host with sort_rays; brute-force checks, legacy_aimed
    against the group walk's aimed leg ``h_aim`` (equal outside the
    near-tie and grazing-edge classes), timings, and the kernel against its
    plain version on each leg's sorted rows. Returns the kernel's entry of
    the ``kernels`` line."""
    a, b, c = tris_np
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris_np)
    t0 = time.perf_counter()
    scene = build_cluster_scene(a, b, c)
    build_s = time.perf_counter() - t0
    sort_s, sorted_np, rays_dev, unsort = {}, {}, {}, {}
    for leg, (lo, ld) in {"legacy_random": (o, d),
                          "legacy_aimed": (ao, ad)}.items():
        (sorted_np[leg], rays_dev[leg], unsort[leg],
         sort_s[leg]) = sort_legacy(lo, ld, dev)
    legs = {
        "legacy_random": lambda: trace_closest_hit(
            scene, Ray.create(*rays_dev["legacy_random"])),
        "legacy_aimed": lambda: trace_closest_hit(
            scene, Ray.create(*rays_dev["legacy_aimed"]), tris=tris_dev),
    }
    # the legacy path: every count is zero before and read after
    obs.reset()
    res = {leg: fn() for leg, fn in legs.items()}
    torch.cuda.synchronize()
    launches = {"cluster_trace": n_launched("cluster_trace")}
    emit("legacy_launches", **launches)
    check(launches["cluster_trace"] > 0,
          "cluster_trace was never launched on the legacy path")
    bf = []
    for seed, (leg, h) in enumerate(res.items(), start=10):
        n = sorted_np[leg][0].shape[0]
        check(h.t.shape == (n,) and h.shape_id.shape == (n,), f"{leg} shape")
        check(bool(((h.shape_id >= 0) == torch.isfinite(h.t)).all())
              and bool((h.t[torch.isfinite(h.t)] > 0).all()),
              f"{leg}: t values or shape ids")
        bf.append(check_vs_brute(leg, *sorted_np[leg], h.t.cpu().numpy(),
                                 tris_dev, seed))
    hit_aim = float(torch.isfinite(res["legacy_aimed"].t).float().mean())
    check(hit_aim >= 0.999, f"legacy_aimed hit fraction {hit_aim} < 0.999")
    # both aimed legs recompute the winner's exact t, so rays with the same
    # winner agree bit for bit; a near tie is one legacy key step (W=128).
    # A one-sided miss within CRACK_BAND (barycentric, on unit cubes) of an
    # edge is the crack class. The legacy table stores each triangle's a'
    # relative to a Morton cluster's centre, up to ~4e4 units away, where
    # float32 keeps 2^-8 of a unit, so two triangles that share an edge may
    # be stored 2^-8 apart, and a ray can pass between them
    # (tests/test_torch_legacy.py::test_table_crack_ray_at_a_cube_edge).
    # The walk's own origin in that frame is an exact float pair
    # (::test_crack_ray_at_a_cube_edge), the scene carries the part of
    # a - cc that the stored a' leaves out (a_lo), and tv and w are formed
    # from both in float64: no crack is left, and the crack class must be
    # empty
    back = torch.from_numpy(unsort["legacy_aimed"]).to(dev)
    h_leg = res["legacy_aimed"]
    h_leg = h_leg._replace(**{f: getattr(h_leg, f)[back]
                              for f in ("t", "u", "v", "shape_id")})

    def edge(h):
        """Barycentric distance of each hit from its triangle's nearest
        edge (+inf on a miss)."""
        w = torch.minimum(torch.minimum(h.u, h.v), 1.0 - h.u - h.v)
        return torch.where(torch.isfinite(h.t), w, float("inf"))

    edge_d = torch.minimum(edge(h_aim), edge(h_leg))
    one_hits = torch.isfinite(h_aim.t) != torch.isfinite(h_leg.t)
    crack = (one_hits & (edge_d <= CRACK_BAND)).cpu().numpy()
    diffs, outside = classify_differences(h_aim, h_leg, ct_mod.CW, crack)
    check(outside == 0, f"legacy_aimed differs from the aimed leg on "
          f"{outside} rays outside the near-tie, grazing-edge and crack "
          "classes")
    cracks = sum(x["class"] == "crack" for x in diffs)
    check(cracks == 0, f"legacy_aimed: {cracks} crack-class rays")
    emit("legacy", triangles=int(a.shape[0]), build_s=build_s,
         sort_s=sort_s, clusters=int(scene.num_clusters),
         nodes=int(scene.num_nodes),
         aimed_vs_group_walk={
             "rays_differ": len(diffs),
             "classes": {k: sum(x["class"] == k for x in diffs)
                         for k in ("near-tie", "grazing-edge", "crack")},
             "one_hits_edge_distance": [float(x) for x in edge_d[one_hits]],
             "differences": diffs[:32],
             "crack_rays": [{**x, "o": ao[x["ray"]].tolist(),
                             "d": ad[x["ray"]].tolist(),
                             "edge_distance": float(edge_d[x["ray"]])}
                            for x in diffs if x["class"] == "crack"]},
         hit_fraction={leg: float(torch.isfinite(h.t).float().mean())
                       for leg, h in res.items()},
         brute_force=bf)

    e2e = {}
    for leg, fn in legs.items():
        ms = cuda_ms(fn)
        e2e[leg] = {"ms": ms, "rays_per_s": rays_dev[leg][0].shape[0]
                    / (ms * 1e-3)}
    emit("legacy_breakdown", card=card, legs={
        leg: device_breakdown(fn, e2e[leg]["ms"]) for leg, fn in legs.items()})

    # the kernel against its plain version on each leg's own sorted rows
    # (the plain walk in chunks of LEGACY_PLAIN_CHUNK rays, so that its
    # batched leaf tests stay within a few GB), both timed there beside the
    # kernel's bound
    def plain(rows, counts=False):
        parts = [legacy_call(ct_mod.cluster_trace_plain, scene,
                             rows[:, s:s + LEGACY_PLAIN_CHUNK].contiguous(),
                             counts=counts)
                 for s in range(0, rows.shape[1], LEGACY_PLAIN_CHUNK)]
        return tuple(torch.cat(x) for x in zip(*parts))

    kernel_ms, plain_ms, work, bounds, vs_plain = {}, {}, {}, {}, {}
    t0 = time.perf_counter()
    for leg in legs:
        rows = ct_mod.ray_rows(Ray.create(*rays_dev[leg]))
        n = rows.shape[1]
        tk, ik = legacy_call(ct_mod.cluster_trace, scene, rows)
        tp, ip, visits, fires = plain(rows, counts=True)
        torch.cuda.synchronize()
        differ = same_bits(tk, ik, tp, ip)
        err["cluster_trace"] = max(err["cluster_trace"], finite_err(tk, tp))
        vs_plain[leg] = {"rays": n, "rays_differ": differ,
                         "hits": int((ik >= 0).sum())}
        check(differ == 0, f"{leg}: {differ} rays differ from plain")
        kernel_ms[leg] = cuda_ms(lambda: legacy_call(ct_mod.cluster_trace,
                                                     scene, rows))
        plain_ms[leg] = cuda_ms(lambda: plain(rows), reps=3, warmup=0)
        v_pr, f_pr = float(visits.float().mean()), float(fires.float().mean())
        work[leg] = {"node_visits": v_pr, "leaf_fires": f_pr,
                     "triangle_tests": f_pr * ct_mod.CW}
        ops = (n * (v_pr * (wide_mod.SLAB_OPS + tight_mod.STEP_OPS)
                    + f_pr * (ct_mod.LEAF_OPS + ct_mod.CW * ct_mod.TRI_OPS))
               + a.shape[0] * wide_mod.TRI_ONCE_OPS)
        nbytes = (ct_mod.N_ROWS * 4 * n + scene.smem_nodes.nbytes
                  + scene.smem_cc.nbytes + scene.tris_rel.nbytes
                  + scene.a_lo.nbytes + 8 * n)
        bms, by = roofline(ops, nbytes)
        bounds[leg] = {"ops": ops, "bytes": nbytes, "bound_ms": bms,
                       "bound_by": by, "ops_ms_at_issue_rate": ops / issue * 1e3}
    emit("legacy_timings", card=card, end_to_end=e2e,
         kernels_vs_plain={"seconds": time.perf_counter() - t0,
                           "runs": vs_plain},
         kernel_ms=kernel_ms, plain_ms=plain_ms, work_per_ray=work,
         bounds=bounds)
    key = "legacy_random"
    return {"name": "cluster_trace", "route": "cuda",
            "source": "bvh_tpu_torch/csrc/cluster_trace.cu",
            "replaces": "bvh_tpu/ops/trace.py:116",
            "launches": launches["cluster_trace"],
            "max_abs_err": err["cluster_trace"], "ms": kernel_ms[key],
            "plain_ms": plain_ms[key], "bound_ms": bounds[key]["bound_ms"],
            "bound_by": bounds[key]["bound_by"], "library_ms": None}


def check_k_closest(leg: str, o, d, t_k, tris_dev, seed: int) -> dict:
    """N_SAMPLE rays of a k-closest leg against brute force: in every slot,
    the brute-force front-facing hits outside the peel-epsilon merge class
    (a hit within 2e-4 relative plus 2e-6 of the one before it merges,
    ops/ordered.py); each slot's t within PERF.md's 2e-4 relative; at most
    one hit fewer than brute force on a ray (the reference's own bound,
    tests/test_k_closest.py) and 0.1% of the sampled slots in all; rows
    ascending."""
    k = t_k.shape[1]
    idx = np.random.default_rng(seed).choice(len(o), N_SAMPLE, replace=False)
    bt = brute_hits(o[idx], d[idx], tris_dev, k + 4).cpu().numpy()
    got = t_k[idx]
    worst, short, slots = 0.0, 0, 0
    for i in range(N_SAMPLE):
        keep = []
        for tv in bt[i][np.isfinite(bt[i])]:
            if not keep or tv > keep[-1] * (1 + 2e-4) + 2e-6:
                keep.append(tv)
        want = np.asarray(keep[:k], np.float32)
        g = got[i][np.isfinite(got[i])]
        check(bool((np.diff(g) > 0).all()), f"{leg}: ray {idx[i]} not ascending")
        check(len(g) >= min(len(want), k) - 1,
              f"{leg}: ray {idx[i]} misses hits {want} (got {g})")
        short += max(min(len(want), k) - len(g), 0)
        m = min(len(g), len(want))
        slots += m
        if m:
            worst = max(worst, float(np.max(np.abs(g[:m] - want[:m])
                                            / want[:m])))
    res = {"leg": leg, "sampled": N_SAMPLE, "k": k, "slots_checked": slots,
           "slots_short": short, "max_rel_t_err": worst,
           "rays_with_2plus": int((np.isfinite(got).sum(axis=1) > 1).sum())}
    check(short <= N_SAMPLE // 1000, f"{leg}: {short} slots missing")
    check(worst <= 2e-4, f"{leg}: max rel t err {worst} > 2e-4")
    return res


# the kernel wrappers the chained queries launch on parts with wide tables,
# and the parts' root gate, each as (the module that calls it, its name)
CHAIN_CALLS = ((trace_mod, "wide_trace"), (trace_mod, "sweep_gate"),
               (near_mod, "nearest_wide"), (trace_mod, "_part_root_gate"))


def recorded(fn, targets=CHAIN_CALLS):
    """Runs ``fn()`` with every function ``(module, name)`` of ``targets``
    replaced by one that calls it and keeps a copy of each call's inputs
    and output (the chain overwrites its ray rows' bound row between
    parts). Returns ``fn()``'s result and {name: [(args, kwargs, out)]}."""
    calls = {name: [] for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def copy(x):
        if isinstance(x, tuple):
            return tuple(copy(y) for y in x)
        return x.clone() if torch.is_tensor(x) else x

    def wrap(name, orig):
        def call(*args, **kw):
            out = orig(*args, **kw)
            calls[name].append((copy(args), {k: copy(v) for k, v in kw.items()},
                                copy(out)))
            return out
        return call

    try:
        for mod, name, orig in saved:
            setattr(mod, name, wrap(name, orig))
        res = fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return res, calls


def plain_of(name: str, args: tuple, kw: dict) -> tuple:
    """The plain version of kernel wrapper ``name`` on one recorded call's
    inputs, the group walks chunked as ``plain_chunked`` and
    ``near_plain`` chunk them."""
    if name == "sweep_gate":
        table = sweep_mod.node_table(args[0], kw.get("packed", False))
        return (sweep_mod.sweep_gate_plain(table, *args[1:], **kw),)
    if name == "wide_trace":
        kw = dict(kw)
        width = kw.pop("width")
        del kw["depth"]
        check(kw["hints"] is None, "hinted chained walk")
        return plain_chunked(wide_mod.wide_trace_plain,
                             (wide_mod.wide_table(args[0]), args[1]), args[2],
                             width, **kw)
    gnodes, grp, pts, width = args[:4]
    chunk = PLAIN_CHUNK // width
    parts = [near_mod.nearest_wide_plain(gnodes, grp,
                                         pts[:, s:s + chunk].contiguous(),
                                         width, **kw)
             for s in range(0, pts.shape[1], chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def compare_recorded(leg: str, calls: dict, err: dict) -> dict:
    """Every kernel launch recorded on a chained leg against its plain
    version on the same card tensors: t or d² bits, lane ids and gates must
    be equal. Returns per kernel the launches, the elements compared, and
    how many differ; raises ``err`` to the largest |kernel - plain|."""
    out = {}
    for name, recs in calls.items():
        if name == "_part_root_gate" or not recs:
            continue
        n, differ = 0, 0
        for args, kw, got in recs:
            # the name of the kernel's entry in the kernels line
            key = "wide_trace_any" if kw.get("mode") == "any" else name
            got = got if isinstance(got, tuple) else (got,)
            want = plain_of(name, args, kw)
            torch.cuda.synchronize()
            bad = torch.zeros(got[0].shape, dtype=torch.bool,
                              device=got[0].device)
            for x, y in zip(got, want):
                bad |= ((x.view(torch.int32) != y.view(torch.int32))
                        if x.is_floating_point() else x != y)
            n += bad.numel()
            differ += int(bad.sum())
            err[key] = max(err.get(key, 0.0),
                           finite_err(got[0].float(), want[0].float()))
        out[name] = {"launches": len(recs), "compared": n, "differ": differ}
        check(differ == 0, f"{leg}/{name}: {differ} of {n} elements differ "
              "from plain")
    return out


def chained_phase(dev, card: str, scene_w, tris_w, n_cubes: int = 84000,
                  max_part: int = 100_000, n_rand: int = 2 << 20,
                  n_aim: int = 1 << 20, n_points: int = N_POINTS) -> dict:
    """Phase 11: chained scenes, the slice's main path at full size:
    bench.py's sparse_1m leg (create_n_cubes(84000), 1,008,000 triangles,
    build_chained_scene(max_part=100_000), 2,097,152 rays, octmorton sort,
    packet 8192, sweep off), the aimed rays on the same chain (closest with
    the exact recompute, and any hit at 1.2x and 0.8x each ray's hit), the
    nearest query on 1,048,576 points, and k=4 closest hits on the 120k
    wide scene and on the chain. Brute-force checks, the kernels against
    their plain versions on the launches of the first four legs, and
    timings. Returns the largest |kernel - plain| by kernel, the chain and
    its vertices (numpy)."""
    a, b, c = tb.create_n_cubes(n_cubes)
    t0 = time.perf_counter()
    ch = build_chained_scene(a, b, c, max_part=max_part)
    build_s = time.perf_counter() - t0
    n_parts = -(-a.shape[0] // max_part)
    check(len(ch.parts) == n_parts, f"{len(ch.parts)} parts, not {n_parts}")
    # every part walks its wide table (the launches recorded below)
    check(all(p.gnodes is not None for p in ch.parts), "a part has no gnodes")
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in (a, b, c))
    o, d = tb.create_rays(n_rand, seed=tb.seed_state_after(n_cubes))
    ao, ad = tb.aimed_rays(a, n_aim)
    pts = tb.create_rays(n_points, seed=tb.seed_state_after(n_cubes + 7))[0]
    o_dev, d_dev = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    ao_dev, ad_dev = torch.from_numpy(ao).to(dev), torch.from_numpy(ad).to(dev)
    pts_dev = torch.from_numpy(pts).to(dev)
    # the 120k scene's aimed rays for its k-closest leg, and both aimed
    # sets morton-sorted once
    wo, wd = tb.aimed_rays(tris_w[0], n_aim)
    wo_dev, wd_dev = torch.from_numpy(wo).to(dev), torch.from_numpy(wd).to(dev)
    perm_a, inv_a = sort_rays_device(ao_dev, ad_dev, mode="morton")
    perm_w, _ = sort_rays_device(wo_dev, wd_dev, mode="morton")
    tris_w_dev = tuple(torch.from_numpy(x).to(dev) for x in tris_w)

    def sparse_1m():
        perm, inv = sort_rays_device(o_dev, d_dev, mode="octmorton")
        od = torch.cat([o_dev, d_dev], dim=1)[perm]
        out = trace_closest_hit_chained(ch, Ray.create(od[:, 0:3], od[:, 3:6]),
                                        packet=8192, sweep=False)
        return out.t[inv], out.shape_id[inv]

    def aimed():
        h = trace_closest_hit_chained(ch, Ray.create(ao_dev, ad_dev),
                                      tris=tris_dev, packet=8192, perm=perm_a)
        return h.t[inv_a], h.shape_id[inv_a]

    t_hit = {}

    def shadow(factor):
        return trace_any_hit_chained(ch, Ray.create(ao_dev, ad_dev),
                                     t_max=t_hit["aimed"] * factor,
                                     packet=8192, perm=perm_a)[inv_a]

    legs = {
        "sparse_1m": sparse_1m,
        "chained_aimed": aimed,
        "chained_shadow": lambda: shadow(1.2),
        "nearest_chained": lambda: nearest_chained(ch, pts_dev),
        "k_closest_120k": lambda: trace_k_closest(
            scene_w, Ray.create(wo_dev[perm_w], wd_dev[perm_w]), k=4,
            packet=8192, tris=tris_w_dev),
        "k_closest_chained": lambda: trace_k_closest_chained(
            ch, Ray.create(ao_dev[perm_a], ad_dev[perm_a]), k=4,
            packet=8192, tris=tris_dev),
    }
    # the chained path: every count is zero before and read after. The
    # launches of the four chained legs are recorded (inputs copied), to be
    # held against the plain versions below
    obs.reset()
    res, calls = {}, {}
    for leg, fn in legs.items():
        if leg.startswith("k_closest"):
            res[leg] = fn()
        else:
            res[leg], calls[leg] = recorded(fn)
        if leg == "chained_aimed":
            t_hit["aimed"] = res[leg][0]
    torch.cuda.synchronize()
    launches = {"wide_trace": n_launched("wide_trace"),
                "wide_trace_any": n_launched("wide_trace.any"),
                "sweep_gate": n_launched("sweep"),
                "nearest_wide": n_launched("nearest_wide")}
    emit("chained_launches", **launches)
    for k_, v in launches.items():
        check(v > 0, f"{k_} was never launched on the chained path")

    # checks against brute force over all 1,008,000 triangles (k_closest_120k
    # over the 120k scene's)
    t_s, sid_s = res["sparse_1m"]
    t_a, sid_a = res["chained_aimed"]
    for leg, (t, sid) in (("sparse_1m", (t_s, sid_s)),
                          ("chained_aimed", (t_a, sid_a))):
        check(bool(((sid >= 0) == torch.isfinite(t)).all()),
              f"{leg}: shape ids disagree with hits")
    hit_a = torch.isfinite(t_a)
    check(float(hit_a.float().mean()) >= 0.999, "chained_aimed hit fraction")
    bf = [check_vs_brute("sparse_1m", o, d, t_s.cpu().numpy(), tris_dev, 20),
          check_vs_brute("chained_aimed", ao, ad, t_a.cpu().numpy(),
                         tris_dev, 21)]
    occ12 = res["chained_shadow"]
    occ08 = shadow(0.8)
    check(bool(occ12[hit_a].all()), "chained_shadow: a ray is clear below "
          "1.2x its closest hit")
    # an occluder within the key truncation (2W ulps) of t_max may count
    tm08 = t_a * 0.8
    band = torch.zeros_like(occ08)
    if occ08.any():
        idx = torch.nonzero(occ08).flatten()
        t_bf = brute_force(ao_dev[idx], ad_dev[idx], tris_dev)
        band[idx] = (t_bf - tm08[idx]).abs() <= 32 * 2.0 ** -23 * tm08[idx]
    n_08 = int((occ08 & ~band).sum())
    check(n_08 == 0, f"chained_shadow: {n_08} rays occluded below 0.8x "
          "their closest hit")
    sid_n, dist_n = res["nearest_chained"]
    bf.append(check_nearest_vs_brute("nearest_chained", pts_dev, sid_n,
                                     dist_n, tris_dev, 22))
    bf.append(check_k_closest("k_closest_120k", wo[perm_w.cpu().numpy()],
                              wd[perm_w.cpu().numpy()],
                              res["k_closest_120k"][0].cpu().numpy(),
                              tris_w_dev, 23))
    bf.append(check_k_closest("k_closest_chained", ao[perm_a.cpu().numpy()],
                              ad[perm_a.cpu().numpy()],
                              res["k_closest_chained"][0].cpu().numpy(),
                              tris_dev, 24))
    # every kernel launch of the four chained legs against its plain version
    # on the launch's own inputs: the rows with each part's carried bound,
    # the root gates as pre-gates, the padded part tables
    t0 = time.perf_counter()
    err = {}
    vs_plain = {leg: compare_recorded(leg, c, err) for leg, c in calls.items()}
    emit("chained_kernels_vs_plain", seconds=time.perf_counter() - t0,
         legs=vs_plain, max_abs_err=err)
    # the parts' root gates: packets gated off per part
    gates = {}
    for leg in ("sparse_1m", "chained_aimed", "chained_shadow"):
        g = torch.stack([out for _, _, out in calls[leg]["_part_root_gate"]])
        check(g.shape[0] == len(ch.parts), f"{leg}: {g.shape[0]} root gates")
        gates[leg] = {"packets": int(g.shape[1]),
                      "parts_gated_off_per_packet": float(
                          (g == 0).sum(dim=0).float().mean()),
                      "open_per_part": [int(x) for x in g.sum(dim=1)]}
    emit("chained", triangles=int(a.shape[0]), parts=len(ch.parts),
         part_triangles=[int(i.shape[0]) for i in ch.orig_ids],
         width=int(ch.parts[0].width), build_s=build_s,
         rays_random=n_rand, rays_aimed=n_aim, points=n_points,
         hit_fraction={"sparse_1m": float(torch.isfinite(t_s).float().mean()),
                       "chained_aimed": float(hit_a.float().mean())},
         shadow={"occluded_at_1_2": float(occ12.float().mean()),
                 "occluded_at_0_8": int(occ08.sum()),
                 "in_t_max_band": int(band.sum())},
         k_closest_hits_per_ray={
             leg: float(res[leg][2].float().mean())
             for leg in ("k_closest_120k", "k_closest_chained")},
         root_gates=gates, brute_force=bf)

    e2e = {}
    for leg, fn in legs.items():
        reps = 3 if leg.startswith("k_closest") else REPS
        ms = cuda_ms(fn, reps=reps, warmup=1)
        count = n_points if leg == "nearest_chained" else (
            n_rand if leg == "sparse_1m" else n_aim)
        e2e[leg] = {"ms": ms, ("points_per_s" if leg == "nearest_chained"
                               else "rays_per_s"): count / (ms * 1e-3)}
    emit("chained_timings", card=card, end_to_end=e2e)
    emit("chained_breakdown", card=card, legs={
        leg: device_breakdown(fn, e2e[leg]["ms"]) for leg, fn in legs.items()})
    return err, ch, (a, b, c)


# ---- phase 13: dynamic scenes and the visit counters ------------------------

REFIT_FRACS = ((0.01, "1pct"), (0.1, "10pct"), (0.5, "50pct"))
# the refit precision class: sampled rays (random and aimed together) whose
# hit mask flips against brute force at one churn level. It was the rows'
# far cluster frame (1 of 8,192 rays on an H100 before the refit scene
# carried a_lo); with the exact frame none flips, and the refit leg is held
# to the rebuild's bounds (PERF.md section 6)
REFIT_CLASS_MAX = 0
N_FAR_POINTS = 1 << 18  # the nearest far-frame leg's points
# the near-tie class of a nearest query: triangles whose float64 squared
# distance lies within 2^-20 (8 float32 ulps) of the least
NEAR_TIE_RTOL = 2.0 ** -20


def bits_equal(x, y) -> bool:
    """Two tensors bit for bit (NaN in place), on any devices."""
    x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return x.shape == y.shape and torch.equal(x, y)


def scenes_equal(s1, s2) -> bool:
    """Two TightScenes' tables bit for bit and their other fields equal."""
    for name in s1._fields:
        x, y = getattr(s1, name), getattr(s2, name)
        if x is None or y is None:
            if not (x is None and y is None):
                return False
        elif torch.is_tensor(x) or isinstance(x, np.ndarray):
            if not bits_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def flat_consistent(h, mn, mx) -> bool:
    """A host FlatBvh is consistent and tight over shape boxes (mn, mx):
    every leaf holds its shape's box, every internal node the join of its
    two children's."""
    leaf = h.entry < 0
    i = np.nonzero(~leaf)[0]
    left = i + 1
    right = h.exit[left]
    return (np.array_equal(h.aabb_min[leaf], mn[h.shape[leaf]])
            and np.array_equal(h.aabb_max[leaf], mx[h.shape[leaf]])
            and np.array_equal(h.aabb_min[i], np.minimum(h.aabb_min[left],
                                                         h.aabb_min[right]))
            and np.array_equal(h.aabb_max[i], np.maximum(h.aabb_max[left],
                                                         h.aabb_max[right])))


def brute_agreement(o, d, t_trace, tris_dev, seed: int) -> dict:
    """``check_vs_brute``'s numbers on 4,096 sampled rays without its
    bounds: the mask agreement, the largest relative t error, and the rays
    outside either bound."""
    idx = np.random.default_rng(seed).choice(len(o), N_SAMPLE, replace=False)
    t_bf = brute_force(o[idx], d[idx], tris_dev).cpu().numpy()
    t_tr = t_trace[idx]
    hit_bf, hit_tr = np.isfinite(t_bf), np.isfinite(t_tr)
    both = hit_bf & hit_tr
    rel = np.zeros(N_SAMPLE)
    rel[both] = np.abs(t_tr[both] - t_bf[both]) / t_bf[both]
    off = (hit_bf != hit_tr) | (rel > 2e-4)
    return {"sampled": N_SAMPLE, "mask_agreement": float((hit_bf == hit_tr)
                                                          .mean()),
            "max_rel_t_err": float(rel.max()), "rays_outside": int(off.sum()),
            "hit_fraction_sampled": float(hit_bf.mean())}


def plain_counts(kind: str, tables: tuple, rows, width: int, **kw):
    """A walk's plain version with ``counts=True`` over chunks of
    PLAIN_CHUNK // W rays or points (each walks on its own): ``kind`` is
    "wide", "tight", "nearest_wide" or "nearest_entry_exit"."""
    fn = {"wide": wide_mod.wide_trace_plain,
          "tight": tight_mod.tight_trace_plain,
          "nearest_wide": near_mod.nearest_wide_plain,
          "nearest_entry_exit": near_mod.nearest_entry_exit_plain}[kind]
    chunk = PLAIN_CHUNK // width
    parts = [fn(*tables, rows[:, s:s + chunk].contiguous(), width,
                counts=True, **kw)
             for s in range(0, rows.shape[1], chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def hold_counting_build(name: str, counted, timed, plain) -> dict:
    """A counting build's (t or d2, lane, count, fires) against the timed
    build's (t or d2, lane) and the plain version's four outputs: fails
    unless all agree bit for bit; returns the comparison."""
    same_timed = bits_equal(counted[0], timed[0]) and bits_equal(counted[1],
                                                                 timed[1])
    same_plain = all(bits_equal(x, y) for x, y in zip(counted, plain))
    fin = torch.isfinite(counted[0]) & torch.isfinite(plain[0])
    err = (float((counted[0][fin] - plain[0][fin]).abs().max())
           if fin.any() else 0.0)
    check(same_timed, f"{name}: the counting build's results differ from the "
                      "timed build's")
    check(same_plain, f"{name}: the counting build differs from the plain "
                      "version's results or counts")
    return {"equal_to_timed": same_timed, "equal_to_plain": same_plain,
            "max_abs_err": err, "count_total": int(counted[2].sum()),
            "fires_total": int(counted[3].sum())}


def far_aimed_rays(a, b, c, n: int, seed: int):
    """``n`` rays from [-60, 60]^3 aimed at triangle centroids up to ~1.4e5
    away (the CPU tests' ``_aimed`` recipe), every fourth turned away,
    numpy."""
    rng = np.random.default_rng(seed)
    centers = (a + b + c) / np.float32(3)
    o = rng.uniform(-60.0, 60.0, (n, 3)).astype(np.float32)
    d = (centers[rng.integers(0, len(a), n)] - o).astype(np.float32)
    d[::4] = -d[::4]
    return o, d


def brute_force64(o, d, tris_dev, chunk: int = 16):
    """Closest t of every ray over all triangles in float64 (directions
    normalized in float32, as the port's rays carry them)."""
    rays = Ray.create(o, d)
    o64, d64 = rays.origin.double(), rays.direction.double()
    a, b, c = (x.double()[None] for x in tris_dev)
    out = []
    for s in range(0, o64.shape[0], chunk):
        dd = d64[s:s + chunk, None]
        r = Ray(o64[s:s + chunk, None], dd, 1.0 / dd)
        out.append(ray_intersects_triangle(r, a, b, c).distance.amin(dim=1))
    return torch.cat(out)


def check_far_frame(leg: str, o, d, t_trace, tris_dev, seed: int,
                    t_rounded=None, sample: bool = True) -> dict:
    """A leg whose rays hit ~1e5 from their origins, on 4,096 sampled rays
    (every ray without ``sample``), against float32 and float64 brute
    force: the mask equals float64 brute force's on every ray checked (no
    flip), and t is within 2e-4 of both. ``t_rounded``: the same rays'
    trace without the exact frame (a measurement only), whose flips
    against float64 are counted."""
    idx = (np.random.default_rng(seed).choice(len(o), N_SAMPLE, replace=False)
           if sample else np.arange(len(o)))
    t_bf = brute_force(o[idx], d[idx], tris_dev).cpu().numpy()
    t64 = brute_force64(o[idx], d[idx], tris_dev).cpu().numpy()
    t_tr = t_trace[idx]
    hit_tr, hit_bf, hit64 = (np.isfinite(x) for x in (t_tr, t_bf, t64))
    flips = np.nonzero(hit_tr != hit_bf)[0]
    both = hit_tr & hit64 & hit_bf
    rel = float(np.max(np.abs(t_tr[both] - t64[both]) / t64[both]))         if both.any() else 0.0
    rel32 = float(np.max(np.abs(t_tr[both] - t_bf[both]) / t_bf[both]))         if both.any() else 0.0
    res = {"leg": leg, "checked": len(idx),
           "mask_agreement_f32": float((hit_tr == hit_bf).mean()),
           "mask_agreement_f64": float((hit_tr == hit64).mean()),
           "flips_vs_f64": [int(idx[i]) for i in
                            np.nonzero(hit_tr != hit64)[0]],
           "flips_vs_f32": [{"ray": int(idx[i]), "trace_hits": bool(hit_tr[i]),
                             "f64_hits": bool(hit64[i])} for i in flips],
           "max_rel_t_err_f64": rel, "max_rel_t_err_f32": rel32,
           "hit_fraction_sampled": float(hit64.mean())}
    if t_rounded is not None:
        res["rounded_frame_flips_vs_f64"] = int(
            (np.isfinite(t_rounded[idx]) != hit64).sum())
    check(not res["flips_vs_f64"],
          f"{leg}: the mask differs from float64 brute force's: {res}")
    check(rel <= 2e-4 and rel32 <= 2e-4, f"{leg}: {res}")
    return res


def shared_edge_case(dev) -> dict:
    """The far frame's shared-edge case: a grid device build of
    create_n_cubes(500) on ``dev`` with its triangles there, and 8,192
    ``far_aimed_rays`` (seed 17) as tensors there."""
    a, b, c = tb.create_n_cubes(500)
    tris = tuple(torch.from_numpy(x).to(dev) for x in (a, b, c))
    o, d = far_aimed_rays(a, b, c, 8192, seed=17)
    return {"scene": build_tight_scene_device(*tris), "tris": tris,
            "rays": (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))}


def far_points(a, b, c, n: int, seed: int = 23):
    """``n`` points scattered (normal, scale 1.5) about triangle centroids
    (the CPU test's recipe), numpy; in a device build their leaves' frame
    origins lie up to ~1e5 away."""
    rng = np.random.default_rng(seed)
    cen = (a + b + c) / np.float32(3)
    return (cen[rng.integers(0, len(a), n)]
            + rng.normal(scale=1.5, size=(n, 3))).astype(np.float32)


def nearest_d2_64(p, tris_dev, sid=None):
    """Float64 squared distances from points ``p`` to all triangles: the
    least [n] (``sid`` None), or to triangle ``sid`` of each point."""
    a, b, c = (x.double() for x in tris_dev)
    p = p.double()
    if sid is not None:
        w = sid.to(torch.int64)
        return point_triangle_distance_squared(p, a[w], b[w], c[w])
    chunk = max(1, (1 << 21) // a.shape[0])
    return torch.cat([point_triangle_distance_squared(
        p[s:s + chunk, None, :], a[None], b[None], c[None]).amin(dim=1)
        for s in range(0, p.shape[0], chunk)])


def check_nearest_far(leg: str, pts_dev, sid, tris_dev, seed: int,
                      sid_rounded) -> dict:
    """N_SAMPLE points of a far-frame leg against float64 brute force: each
    reported triangle's float64 squared distance is the least within the
    near-tie class (``NEAR_TIE_RTOL``); the rounded frame's triangles
    (``sid_rounded``, the same walk without ``a_lo``, a measurement only)
    outside the class are counted."""
    idx = torch.from_numpy(np.random.default_rng(seed).choice(
        pts_dev.shape[0], N_SAMPLE, replace=False)).to(pts_dev.device)
    p, s, sr = pts_dev[idx], sid[idx], sid_rounded[idx]
    check(bool((s >= 0).all()), f"{leg}: a point found no triangle")
    best = nearest_d2_64(p, tris_dev)
    own = nearest_d2_64(p, tris_dev, s)
    own_r = nearest_d2_64(p, tris_dev, sr)
    lim = best * (1.0 + NEAR_TIE_RTOL)
    outside = int((own > lim).sum())
    res = {"leg": leg, "sampled": N_SAMPLE, "outside_tie_class": outside,
           "max_rel_excess": float(((own - best) / best.clamp_min(1e-300))
                                   .max()),
           "rounded_frame_outside_tie_class": int((own_r > lim).sum()),
           "rounded_frame_max_rel_excess": float(
               ((own_r - best) / best.clamp_min(1e-300)).max())}
    check(outside == 0, f"{leg}: a reported triangle is not float64 brute "
                        f"force's nearest: {res}")
    return res


def dynamic_phase(dev, card: str, scene, tris, o, d, ao, ad, issue: float,
                  n_cubes: int = 84000, max_part: int = 100_000):
    """Phase 13: bench.py's dynamic-scene legs and its roofline at full size
    on the 120k scene, with the visit counters: update_shapes_flat,
    tight_refit, refit_quality (the refit scene, a host rebuild and
    make_updater's chained scene at 1%, 10% and 50% churn), device builds
    (grid and LBVH upper trees on the 120k scene, the 1,008,000-triangle
    chain), nearest over an update, and count_visits_* on the headline
    rows, and the nearest far-frame leg (both walks on the grid device
    build). Returns the ``kernels`` line's entries of the counting and
    FRAME builds, and the scenes and rays phase 15 saves and loads."""
    a, b, c = tris
    n_tris = a.shape[0]
    W = int(scene.width)
    o_dev, d_dev = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    ao_dev, ad_dev = torch.from_numpy(ao).to(dev), torch.from_numpy(ad).to(dev)
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris)
    n_rays = o.shape[0]

    # ---- set-up (not timed): bench.py's inputs ------------------------
    t0 = time.perf_counter()
    mn, mx = tb.tri_aabbs(a, b, c)
    a2, b2, c2, _ = tb.randomly_transform_scene(a, b, c, amount=n_tris // 2,
                                                seed=9)
    mn2, mx2 = tb.tri_aabbs(a2, b2, c2)
    flat, _ = build_sah(mn, mx)
    flat_dev = flat.to_device(device=dev)
    mn2_dev, mx2_dev = (torch.from_numpy(x).to(dev) for x in (mn2, mx2))
    v2 = tuple(torch.from_numpy(x).to(dev) for x in (a2, b2, c2))
    refitter = make_refitter(scene, device=dev)
    churn = {}
    for frac, label in REFIT_FRACS:
        amount = int(n_tris * frac)
        am, bm, cm, moved = tb.randomly_transform_scene(a, b, c,
                                                        amount=amount, seed=13)
        t1 = time.perf_counter()
        host = build_tight_scene(am, bm, cm)
        churn[label] = {
            "amount": amount, "tris": (am, bm, cm),
            "verts": tuple(torch.from_numpy(x).to(dev) for x in (am, bm, cm)),
            "moved": torch.from_numpy(moved.astype(np.int32)).to(dev),
            "updater": make_updater(scene, max_moved=amount, device=dev),
            "host_rebuild": host, "host_build_s": time.perf_counter() - t1}
    sa, sb, sc_ = tb.create_n_cubes(n_cubes)
    sparse_dev = tuple(torch.from_numpy(x).to(dev) for x in (sa, sb, sc_))
    sao, sad = tb.aimed_rays(sa, len(ao))
    sao_dev, sad_dev = (torch.from_numpy(x).to(dev) for x in (sao, sad))
    perm_s, inv_s = sort_rays_device(sao_dev, sad_dev, mode="morton")
    t1 = time.perf_counter()
    scene_ee = build_tight_scene(a, b, c, wide=False)
    ee_build_s = time.perf_counter() - t1
    rows_r = trace_rows(o_dev, d_dev, "octmorton")  # the roofline's rows
    perm_r, _ = sort_rays_device(o_dev, d_dev, mode="octmorton")
    rays_roof = Ray.create(o_dev[perm_r], d_dev[perm_r])
    pts = torch.from_numpy(tb.create_rays(
        N_POINTS, seed=tb.seed_state_after(10007))[0]).to(dev)
    n_near = N_POINTS // 4  # the counting builds' nearest rows
    pts_s = pts[sort_points_device(pts)[0][:n_near]]
    fo, fd = far_aimed_rays(a, b, c, len(ao), seed=17)
    fo_dev, fd_dev = torch.from_numpy(fo).to(dev), torch.from_numpy(fd).to(dev)
    fp_dev = torch.from_numpy(far_points(a, b, c, N_FAR_POINTS)).to(dev)
    setup_s = time.perf_counter() - t0

    def trace_q(sc):
        """bench.py's refit_quality run: the reference rays, octmorton
        sorted inside the call, packet 8192, no sweep; t in ray order."""
        perm, inv = sort_rays_device(o_dev, d_dev, mode="octmorton")
        od = torch.cat([o_dev, d_dev], dim=1)[perm]
        rays = Ray.create(od[:, 0:3], od[:, 3:6])
        if hasattr(sc, "parts"):
            out = trace_closest_hit_chained(sc, rays, packet=8192,
                                            sweep=False)
        else:
            out = trace_closest_hit_tight(sc, rays, packet=8192, sweep=False)
        return out.t[inv]

    idx_a = np.random.default_rng(21).choice(len(ao), N_SAMPLE, replace=False)
    idx_a_dev = torch.from_numpy(idx_a).to(dev)

    def aimed_sample(sc, tris_m):
        """4,096 of the aimed rays through ``sc`` with the exact winner
        recompute (the chained scenes with the sweep gate on)."""
        rays = Ray.create(ao_dev[idx_a_dev], ad_dev[idx_a_dev])
        if hasattr(sc, "parts"):
            return trace_closest_hit_chained(sc, rays, tris=tris_m,
                                             packet=1024).t
        return trace_closest_hit_tight(sc, rays, tris=tris_m, packet=1024).t

    # ---- the main path of phase 13: every count zero before, read after
    obs.reset()
    flat_new = update_shapes(flat_dev, mn2_dev, mx2_dev)
    refit_scene = refitter(*v2)
    quality = {}
    for label, ch in churn.items():
        ch["refit"] = refitter(*ch["verts"])
        ch["update"] = ch["updater"](*ch["verts"], ch["moved"])
        for cell in ("refit", "host_rebuild", "update"):
            quality[(label, cell)] = (trace_q(ch[cell]),
                                      aimed_sample(ch[cell], ch["verts"]))
    dev_scenes = {"grid": build_tight_scene_device(*tris_dev),
                  "lbvh": build_tight_scene_device(*tris_dev, upper="lbvh")}
    dev_chain = build_chained_scene_device(*sparse_dev, max_part=max_part)
    dev_hits = {}
    for kind, sc in dev_scenes.items():
        dev_hits[kind] = make_tracer(sc, packet=8192, sort="morton",
                                     tris=tris)(ao_dev, ad_dev).t
    # the far-frame leg: the exact cluster frame at ~1e5
    dev_hits["far"] = make_tracer(dev_scenes["grid"], packet=8192,
                                  sort="morton", tris=tris)(fo_dev, fd_dev).t
    h = trace_closest_hit_chained(dev_chain, Ray.create(sao_dev, sad_dev),
                                  tris=sparse_dev, packet=8192, perm=perm_s)
    dev_hits["chain"] = h.t[inv_s]
    upd10 = churn["10pct"]["update"]
    near_upd = nearest_chained(upd10, pts)
    near_static_ee = nearest_tight(upd10.parts[0], pts, wide=False)
    roof_w = count_visits_wide(scene, rays_roof, packet=8192)
    roof_t = count_visits_tight(scene_ee, rays_roof, packet=8192)
    roof_n = {wide: count_visits_nearest(upd10.parts[0], pts_s, packet=8192,
                                         wide=wide) for wide in (True, False)}
    # the nearest far-frame leg: both walks in the exact cluster frame
    near_far = {wide: nearest_tight(dev_scenes["grid"], fp_dev, wide=wide)
                for wide in (True, False)}
    torch.cuda.synchronize()
    launches = {"wide_trace": n_launched("wide_trace"),
                "tight_trace": n_launched("tight_trace"),
                "sweep_gate": n_launched("sweep"),
                "nearest_wide": n_launched("nearest_wide"),
                "nearest_tight": n_launched("nearest_entry_exit"),
                "wide_trace_count": n_launched("wide_trace_count"),
                "tight_trace_count": n_launched("tight_trace_count"),
                "nearest_wide_count": n_launched("nearest_wide_count"),
                "nearest_tight_count": n_launched("nearest_entry_exit_count"),
                "wide_trace_frame": n_launched("wide_trace.frame"),
                "tight_trace_frame": n_launched("tight_trace.frame"),
                "nearest_wide_frame": n_launched("nearest_wide.frame"),
                "nearest_tight_frame": n_launched("nearest_entry_exit.frame")}
    emit("dynamic_main_path_launches", **launches)
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on phase 13's main path")

    # ---- checks ---------------------------------------------------------
    flat_cpu = update_shapes(flat.to_device(device="cpu"),
                             torch.from_numpy(mn2), torch.from_numpy(mx2))
    same_flat = all(bits_equal(x, y) for x, y in zip(flat_new, flat_cpu))
    check(same_flat, "update_shapes on the card differs from the CPU's")
    check(flat_consistent(flat_new.to_host(), mn2, mx2),
          "update_shapes: the tree is not consistent and tight")
    refit_cpu = make_refitter(scene, device="cpu")(a2, b2, c2)
    check(scenes_equal(refit_scene, refit_cpu),
          "tight_refit on the card differs from the CPU's")
    for kind in ("grid", "lbvh"):
        check(scenes_equal(dev_scenes[kind], build_tight_scene_device(
            *tris, upper=kind, device="cpu")),
            f"device build ({kind}) on the card differs from the CPU's")
    n_parts = -(-sa.shape[0] // max_part)
    check(len(dev_chain.parts) == n_parts,
          f"the device chain has {len(dev_chain.parts)} parts, not {n_parts}")
    checks = {}
    refit_class = {}
    for (label, cell), (t_q, t_s) in quality.items():
        tris_m = churn[label]["verts"]
        t_q, t_s = t_q.cpu().numpy(), t_s.cpu().numpy()
        check(t_q.shape == (n_rays,) and t_s.shape == (N_SAMPLE,),
              f"refit_quality {label}/{cell}: output shape")
        rnd = brute_agreement(o, d, t_q, tris_m, 40 + len(checks))
        bf_s = brute_force(ao[idx_a], ad[idx_a], tris_m).cpu().numpy()
        hit_s, hit_b = np.isfinite(t_s), np.isfinite(bf_s)
        both = hit_s & hit_b
        rel = np.abs(t_s[both] - bf_s[both]) / bf_s[both]
        aimed = {"sampled": N_SAMPLE,
                 "mask_agreement": float((hit_s == hit_b).mean()),
                 "max_rel_t_err": float(rel.max()) if both.any() else 0.0,
                 "rays_outside": int((hit_s != hit_b).sum()
                                     + (rel > 2e-4).sum()),
                 "hit_fraction_sampled": float(hit_b.mean())}
        checks[f"{label}_{cell}"] = {"random": rnd, "aimed": aimed}
        if cell == "refit":
            # the refit precision class: rays outside the rebuild's bounds
            refit_class[label] = rnd["rays_outside"] + aimed["rays_outside"]
            check(refit_class[label] <= REFIT_CLASS_MAX,
                  f"refit_quality {label}/refit: beyond its precision "
                  f"class: {checks[f'{label}_{cell}']}")
        for leg_, r in (("random", rnd), ("aimed", aimed)):
            check(r["mask_agreement"] >= 0.9999
                  and r["max_rel_t_err"] <= 2e-4,
                  f"refit_quality {label}/{cell}/{leg_}: {r}")
    dev_checks = {kind: check_vs_brute(f"device_build_{kind}", ao, ad,
                                       dev_hits[kind].cpu().numpy(), tris_dev,
                                       50 + i)
                  for i, kind in enumerate(("grid", "lbvh"))}
    dev_checks["chain"] = check_vs_brute("device_build_chain", sao, sad,
                                         dev_hits["chain"].cpu().numpy(),
                                         sparse_dev, 53)
    # the same rays without the exact frame: a measurement, never a path
    t_rounded = make_tracer(dev_scenes["grid"]._replace(a_lo=None),
                            packet=8192, sort="morton",
                            tris=tris)(fo_dev, fd_dev).t.cpu().numpy()
    dev_checks["far_frame"] = check_far_frame(
        "device_build_far_frame", fo, fd, dev_hits["far"].cpu().numpy(),
        tris_dev, 55, t_rounded)
    # the shared-edge case at its own size, every ray checked: a grid
    # device build of create_n_cubes(500) and 8,192 far aimed rays, where
    # the float32 form of tv and w missed rays 374, 2843 and 4003
    edge = shared_edge_case(dev)
    e_rays = Ray.create(*edge["rays"])
    t_edge = trace_closest_hit_tight(edge["scene"], e_rays, tris=edge["tris"],
                                     packet=1024).t.cpu().numpy()
    t_edge_r = trace_closest_hit_tight(
        edge["scene"]._replace(a_lo=None), e_rays, tris=edge["tris"],
        packet=1024).t.cpu().numpy()
    dev_checks["shared_edges"] = check_far_frame(
        "device_build_shared_edges", *(x.cpu().numpy() for x in edge["rays"]),
        t_edge, edge["tris"], 0, t_edge_r, sample=False)
    check(bool(np.isfinite(t_edge[[374, 2843, 4003]]).all()),
          "shared edges: rays 374, 2843 or 4003 missed")
    sid_u, dist_u = near_upd
    sid_e, dist_e = near_static_ee
    moved10 = churn["10pct"]["verts"]
    near_check = check_nearest_vs_brute("nearest_update_10pct", pts, sid_u,
                                        dist_u, moved10, 54)
    # the nearest far-frame leg against float64 brute force; the same
    # points without the exact frame (a measurement, never a path)
    g_round = dev_scenes["grid"]._replace(a_lo=None)
    far_checks = {}
    for wide, (sid_f, dist_f) in near_far.items():
        leg = "nearest_far_frame_" + ("wide" if wide else "entry_exit")
        check(sid_f.shape == (N_FAR_POINTS,)
              and bool(torch.isfinite(dist_f).all()), f"{leg}: outputs")
        sid_r, _ = nearest_tight(g_round, fp_dev, wide=wide)
        far_checks[leg] = check_nearest_far(leg, fp_dev, sid_f, tris_dev,
                                            56 + wide, sid_r)
    sw_, dw_ = near_far[True]
    se_, de_ = near_far[False]
    check(bool(torch.equal(dw_.view(torch.int32), de_.view(torch.int32))),
          "nearest far frame: the two walks' distances differ")
    emit("dynamic_path", card=card, setup_s=setup_s,
         sah_nodes=int(flat.num_nodes), entry_exit_build_s=ee_build_s,
         host_build_s={k: v["host_build_s"] for k, v in churn.items()},
         update_shapes_equal_cpu=same_flat, tight_refit_equal_cpu=True,
         device_builds_equal_cpu=True, refit_quality_checks=checks,
         refit_class_rays=refit_class, device_build_checks=dev_checks,
         nearest_update=near_check, nearest_far_frame=far_checks,
         nearest_far_frame_walks_ids_differ=int((sw_ != se_).sum()),
         static_entry_exit_hits=int((sid_e >= 0).sum()))

    # ---- the counting builds against the timed builds and plain counts
    t0 = time.perf_counter()
    gn, grp = _dev(scene.gnodes, dev), _dev(scene.groups, dev)
    rec = records(scene, dev)
    ee_tab, ee_grp = _dev(scene_ee.smem_nodes, dev), _dev(scene_ee.groups, dev)
    ee_rec = node_recs(scene_ee.smem_nodes, dev)
    static = upd10.parts[0]
    s_grp = _dev(static.groups, dev)
    s_gn, s_sn = _dev(static.gnodes, dev), _dev(static.smem_nodes, dev)
    prow = near_mod.point_rows(pts_s, None)
    # the builds the counters launch: host builds carry a_lo (FRAME)
    alo, ee_alo = _dev(scene.a_lo, dev), _dev(scene_ee.a_lo, dev)
    s_alo = _dev(static.a_lo, dev)
    runs = {
        "wide_trace_count": (
            lambda: wide_mod.wide_trace(rec, grp, rows_r, W, scene.gdepth,
                                        counts=True, a_lo=alo),
            lambda: wide_mod.wide_trace(rec, grp, rows_r, W, scene.gdepth,
                                        a_lo=alo),
            lambda: plain_counts("wide", (gn, grp), rows_r, W, packet=8192,
                                 a_lo=alo)),
        "tight_trace_count": (
            lambda: tight_mod.tight_trace(ee_rec, ee_grp, rows_r, W,
                                          counts=True, a_lo=ee_alo),
            lambda: tight_mod.tight_trace(ee_rec, ee_grp, rows_r, W,
                                          a_lo=ee_alo),
            lambda: plain_counts("tight", (ee_tab, ee_grp), rows_r, W,
                                 packet=8192, a_lo=ee_alo)),
        "nearest_wide_count": (
            lambda: near_mod.nearest_wide(s_gn, s_grp, prow, W,
                                          static.gdepth, refine=False,
                                          counts=True, a_lo=s_alo),
            lambda: near_mod.nearest_wide(s_gn, s_grp, prow, W,
                                          static.gdepth, refine=False,
                                          a_lo=s_alo),
            lambda: plain_counts("nearest_wide", (s_gn, s_grp), prow, W,
                                 refine=False, a_lo=s_alo)),
        "nearest_tight_count": (
            lambda: near_mod.nearest_entry_exit(s_sn, s_grp, prow, W,
                                                refine=False, counts=True,
                                                a_lo=s_alo),
            lambda: near_mod.nearest_entry_exit(s_sn, s_grp, prow, W,
                                                refine=False, a_lo=s_alo),
            lambda: plain_counts("nearest_entry_exit", (s_sn, s_grp), prow,
                                 W, refine=False, a_lo=s_alo))}
    holds = {}
    for name, (counted, timed, plain) in runs.items():
        holds[name] = hold_counting_build(name, counted(), timed(), plain())
    # the trace walks' counting builds again on the aimed rows (morton
    # sorted), where every ray fires leaves
    rows_a = trace_rows(ao_dev, ad_dev, "morton")
    holds["wide_trace_count/aimed"] = hold_counting_build(
        "wide_trace_count/aimed",
        wide_mod.wide_trace(rec, grp, rows_a, W, scene.gdepth, counts=True,
                            a_lo=alo),
        wide_mod.wide_trace(rec, grp, rows_a, W, scene.gdepth, a_lo=alo),
        plain_counts("wide", (gn, grp), rows_a, W, packet=8192, a_lo=alo))
    holds["tight_trace_count/aimed"] = hold_counting_build(
        "tight_trace_count/aimed",
        tight_mod.tight_trace(ee_rec, ee_grp, rows_a, W, counts=True,
                              a_lo=ee_alo),
        tight_mod.tight_trace(ee_rec, ee_grp, rows_a, W, a_lo=ee_alo),
        plain_counts("tight", (ee_tab, ee_grp), rows_a, W, packet=8192,
                     a_lo=ee_alo))
    # the counters' totals equal the counting builds' per-ray sums
    check(int(roof_w[2].sum()) == holds["wide_trace_count"]["count_total"]
          and int(roof_w[1].sum()) == holds["wide_trace_count"]["fires_total"],
          "count_visits_wide's totals differ from the counting build's")
    check(int(roof_t[0].sum()) == holds["tight_trace_count"]["count_total"],
          "count_visits_tight's totals differ from the counting build's")
    check(int(roof_n[True][0].sum())
          == holds["nearest_wide_count"]["count_total"],
          "count_visits_nearest's totals differ from the counting build's")
    emit("counting_builds_vs_timed_and_plain",
         seconds=time.perf_counter() - t0, holds=holds)

    # ---- the FRAME builds against their plain versions -----------------
    t0 = time.perf_counter()
    g_sc, l_sc = dev_scenes["grid"], dev_scenes["lbvh"]
    refit1 = churn["1pct"]["refit"]
    rows_f = trace_rows(fo_dev, fd_dev, "morton")
    rows_q = rows_r[:, :1 << 18].contiguous()
    rows_e = trace_rows(*edge["rays"], None)  # unsorted

    def wide_f(sc, rows, **kw):
        return wide_mod.wide_trace(records(sc, dev), sc.groups, rows, W,
                                   sc.gdepth, a_lo=sc.a_lo, **kw)

    def wide_fp(sc, rows, **kw):
        return wide_plain_chunked(sc.gnodes, sc.groups, rows, W,
                                  a_lo=sc.a_lo, **kw)

    def tight_f(sc, rows, **kw):
        return tight_mod.tight_trace(node_recs(sc.smem_nodes, dev), sc.groups,
                                     rows, W, a_lo=sc.a_lo, **kw)

    def tight_fp(sc, rows, **kw):
        return tight_plain_chunked(sc.smem_nodes, sc.groups, rows, W,
                                   a_lo=sc.a_lo, **kw)

    frame_cases = {
        "wide_trace_frame/grid_aimed": (wide_f, wide_fp, g_sc, rows_a),
        "wide_trace_frame/grid_far": (wide_f, wide_fp, g_sc, rows_f),
        "wide_trace_frame/refit_1pct_random": (wide_f, wide_fp, refit1,
                                                rows_q),
        "tight_trace_frame/lbvh_aimed": (tight_f, tight_fp, l_sc, rows_a),
        "tight_trace_frame/lbvh_far": (tight_f, tight_fp, l_sc, rows_f),
        "wide_trace_frame/shared_edges": (wide_f, wide_fp, edge["scene"],
                                          rows_e),
        "tight_trace_frame/shared_edges": (tight_f, tight_fp, edge["scene"],
                                           rows_e)}
    frame_err = {"wide_trace_frame": 0.0, "tight_trace_frame": 0.0}
    frame_holds = {}
    for case, (kf, pf, sc, rows) in frame_cases.items():
        check(sc.a_lo is not None, f"{case}: the scene carries no a_lo")
        tk, ik = kf(sc, rows)
        tp, ip = pf(sc, rows)
        same = bits_equal(tk, tp) and bits_equal(ik, ip)
        check(same, f"{case}: the FRAME build differs from its plain version")
        fin = torch.isfinite(tk)
        name_ = case.split("/")[0]
        frame_err[name_] = max(frame_err[name_], float(
            (tk[fin] - tp[fin]).abs().max()) if fin.any() else 0.0)
        frame_holds[case] = {"rays": int(rows.shape[1]), "bit_equal": same,
                             "hits": int(fin.sum())}
    # the FRAME counting builds, against the FRAME timed builds and plain
    for name_, kf, pf, sc in (("wide_trace_frame", wide_f, wide_fp, g_sc),
                              ("tight_trace_frame", tight_f, tight_fp, l_sc)):
        frame_holds[f"{name_}_count/aimed"] = hold_counting_build(
            f"{name_}_count/aimed", kf(sc, rows_a, counts=True),
            kf(sc, rows_a), pf(sc, rows_a, counts=True))
        frame_holds[f"{name_}_count/shared_edges"] = hold_counting_build(
            f"{name_}_count/shared_edges", kf(edge["scene"], rows_e,
                                              counts=True),
            kf(edge["scene"], rows_e), pf(edge["scene"], rows_e, counts=True))
    # both nearest FRAME builds, timed and counting, on the far points'
    # sorted rows of the grid build
    rows_fp = near_mod.point_rows(fp_dev[sort_points_device(fp_dev)[0]],
                                  None)
    for kind, name_ in (("wide", "nearest_wide_frame"),
                        ("entry_exit", "nearest_tight_frame")):
        dk, ik = near_kernel(kind, g_sc, rows_fp, frame=True)
        dp, ip = near_plain(kind, g_sc, rows_fp, frame=True)
        same = bits_equal(dk, dp) and bits_equal(ik, ip)
        check(same, f"{name_}: the FRAME build differs from its plain version")
        frame_err[name_] = finite_err(dk, dp)
        frame_holds[f"{name_}/grid_far_points"] = {
            "points": int(rows_fp.shape[1]), "bit_equal": same,
            "hits": int((ik >= 0).sum())}
        frame_holds[f"{name_}_count/far_points"] = hold_counting_build(
            f"{name_}_count/far_points",
            near_kernel(kind, g_sc, rows_fp, frame=True, counts=True),
            (dk, ik), near_plain(kind, g_sc, rows_fp, counts=True,
                                 frame=True))
    # row 1 (and 3) with and without FRAME on the same rows: without it
    # a_lo is ignored (a measuring run, never a path)
    rec_g, rec_l = records(g_sc, dev), node_recs(l_sc.smem_nodes, dev)
    frame_turns = {
        "wide": in_turns({
            "frame": lambda: wide_f(g_sc, rows_a),
            "without_frame": lambda: wide_mod.wide_trace(
                rec_g, g_sc.groups, rows_a, W, g_sc.gdepth)}),
        "tight": in_turns({
            "frame": lambda: tight_f(l_sc, rows_a),
            "without_frame": lambda: tight_mod.tight_trace(
                rec_l, l_sc.groups, rows_a, W)}),
        # rows 6 and 5: both nearest walks on the far points' rows
        "nearest_wide": in_turns({
            "frame": lambda: near_kernel("wide", g_sc, rows_fp, frame=True),
            "without_frame": lambda: near_kernel("wide", g_sc, rows_fp,
                                                 frame=False)}),
        "nearest_tight": in_turns({
            "frame": lambda: near_kernel("entry_exit", g_sc, rows_fp,
                                         frame=True),
            "without_frame": lambda: near_kernel("entry_exit", g_sc,
                                                 rows_fp, frame=False)})}
    for v in frame_turns.values():
        v["ratio"] = v["frame"]["ms"] / v["without_frame"]["ms"]
    frame_plain_ms = {
        "wide_trace_frame": cuda_ms(lambda: wide_fp(g_sc, rows_a), reps=3,
                                    warmup=0),
        "tight_trace_frame": cuda_ms(lambda: tight_fp(l_sc, rows_a), reps=3,
                                     warmup=0),
        "nearest_wide_frame": cuda_ms(lambda: near_plain(
            "wide", g_sc, rows_fp, frame=True), reps=3, warmup=0),
        "nearest_tight_frame": cuda_ms(lambda: near_plain(
            "entry_exit", g_sc, rows_fp, frame=True), reps=3, warmup=0)}
    n_a = rows_a.shape[1]
    ray_bytes_a = wide_mod.N_ROWS * 4 * n_a + 16 * n_a
    frame_bounds = {}
    for name_, wide_, sc, table in (("wide_trace_frame", True, g_sc, rec_g),
                                    ("tight_trace_frame", False, l_sc, rec_l)):
        hold = frame_holds[f"{name_}_count/aimed"]
        frame_bounds[name_] = walk_bound(
            n_a, W, hold["count_total"] / n_a, hold["fires_total"] / n_a,
            wide_, ray_bytes_a + table.nbytes + sc.groups.nbytes
            + sc.a_lo.nbytes, n_tris, frame=True)
    n_fp = rows_fp.shape[1]
    for kind, name_ in (("wide", "nearest_wide_frame"),
                        ("entry_exit", "nearest_tight_frame")):
        hold = frame_holds[f"{name_}_count/far_points"]
        steps_pp, fires_pp = (hold["count_total"] / n_fp,
                              hold["fires_total"] / n_fp)
        wide_ = kind == "wide"
        ops = (n_fp * near_mod.walk_ops(wide_, W, steps_pp, fires_pp,
                                        frame=True)
               + n_tris * near_mod.TRI_ONCE_OPS)
        table = g_sc.gnodes if wide_ else g_sc.smem_nodes
        nbytes = ((near_mod.N_ROWS * 4 + 8) * n_fp + table.nbytes
                  + g_sc.groups.nbytes + g_sc.a_lo.nbytes)
        bms, by = roofline(ops, nbytes)
        frame_bounds[name_] = {"ops": ops, "bytes": nbytes, "bound_ms": bms,
                               "bound_by": by, "steps_per_point": steps_pp,
                               "fires_per_point": fires_pp,
                               "ops_ms_at_issue_rate": ops / issue * 1e3}
    emit("frame_builds_vs_plain", card=card,
         seconds=time.perf_counter() - t0, holds=frame_holds,
         in_turns=frame_turns, plain_ms=frame_plain_ms, bounds=frame_bounds,
         max_abs_err=frame_err)

    # ---- timings ----------------------------------------------------------
    e2e = {"update_shapes_flat": cuda_ms(
               lambda: update_shapes(flat_dev, mn2_dev, mx2_dev)),
           "tight_refit": cuda_ms(lambda: refitter.core(*v2)),
           "device_build_grid": cuda_ms(
               lambda: build_tight_scene_device(*tris_dev), reps=5),
           "device_build_lbvh": cuda_ms(
               lambda: build_tight_scene_device(*tris_dev, upper="lbvh"),
               reps=5),
           "device_build_chain_1m": cuda_ms(
               lambda: build_chained_scene_device(*sparse_dev,
                                                  max_part=max_part), reps=3),
           "update_10pct": cuda_ms(lambda: churn["10pct"]["updater"](
               *churn["10pct"]["verts"], churn["10pct"]["moved"]))}
    q_ms, q_break = {}, {}
    for label, ch in churn.items():
        for cell in ("refit", "host_rebuild", "update"):
            key = f"{label}_{cell}"
            ms = cuda_ms(lambda sc=ch[cell]: trace_q(sc), reps=5)
            q_ms[key] = {"ms": ms, "rays_per_s": n_rays / (ms * 1e-3)}
            q_break[key] = device_breakdown(lambda sc=ch[cell]: trace_q(sc),
                                            ms)
    emit("refit_quality", card=card, legs=q_ms, breakdown=q_break)
    kernel_ms, plain_ms = {}, {}
    for name, (counted, timed, plain) in runs.items():
        kernel_ms[name] = cuda_ms(counted)
        kernel_ms[name.removesuffix("_count")] = cuda_ms(timed)
        plain_ms[name] = cuda_ms(plain, reps=3, warmup=0)
    # the roofline: totals per packet, device ns per serial unit of the
    # ungated walks on these rows, and the bounds from the same counts
    n_p = int(roof_w[0].shape[0])
    tests_pr = holds["wide_trace_count"]["count_total"] / n_rays
    wfires_pr = holds["wide_trace_count"]["fires_total"] / n_rays
    visits_pr = holds["tight_trace_count"]["count_total"] / n_rays
    tfires_pr = holds["tight_trace_count"]["fires_total"] / n_rays
    ray_bytes = wide_mod.N_ROWS * 4 * n_rays + 16 * n_rays
    bounds = {
        "wide_trace_count": walk_bound(
            n_rays, W, tests_pr, wfires_pr, True,
            ray_bytes + rec.nbytes + grp.nbytes + alo.nbytes, n_tris,
            frame=True),
        "tight_trace_count": walk_bound(
            n_rays, W, visits_pr, tfires_pr, False,
            ray_bytes + ee_rec.nbytes + ee_grp.nbytes + ee_alo.nbytes,
            n_tris, frame=True)}
    for name, wide, table in (("nearest_wide_count", True, s_gn),
                              ("nearest_tight_count", False, s_sn)):
        steps_pp = holds[name]["count_total"] / n_near
        fires_pp = holds[name]["fires_total"] / n_near
        ops = (n_near * near_mod.walk_ops(wide, W, steps_pp, fires_pp,
                                          frame=True)
               + n_tris * near_mod.TRI_ONCE_OPS)
        nbytes = ((near_mod.N_ROWS * 4 + 16) * n_near + table.nbytes
                  + s_grp.nbytes + s_alo.nbytes)
        bms, by = roofline(ops, nbytes)
        bounds[name] = {"ops": ops, "bytes": nbytes, "bound_ms": bms,
                        "bound_by": by, "steps_per_point": steps_pp,
                        "fires_per_point": fires_pp}
    iters_tot = int(roof_w[0].sum())
    roof = {
        "wide": {"config": "ungated group walk (the counters' configuration)",
                 "packets": n_p, "serial_unit": "iterations (group tests "
                 "plus leaf fires of each ray's own walk)",
                 "iterations_total": iters_tot,
                 "fires_total": int(roof_w[1].sum()),
                 "group_tests_total": int(roof_w[2].sum()),
                 "iterations_per_packet": iters_tot / n_p,
                 "kernel_ms": kernel_ms["wide_trace"],
                 "ns_per_serial_unit": kernel_ms["wide_trace"] * 1e6
                 / iters_tot,
                 "bound_ms": bounds["wide_trace_count"]["bound_ms"],
                 "ops_ms_at_issue_rate": bounds["wide_trace_count"]["ops"]
                 / issue * 1e3},
        "tight": {"config": "ungated entry/exit walk on a wide=False build",
                  "packets": int(roof_t[0].shape[0]),
                  "serial_unit": "node visits of each ray's own walk",
                  "visits_total": int(roof_t[0].sum()),
                  "fires_total": int(roof_t[1].sum()),
                  "visits_per_packet": int(roof_t[0].sum())
                  / int(roof_t[0].shape[0]),
                  "kernel_ms": kernel_ms["tight_trace"],
                  "ns_per_serial_unit": kernel_ms["tight_trace"] * 1e6
                  / int(roof_t[0].sum()),
                  "bound_ms": bounds["tight_trace_count"]["bound_ms"],
                  "ops_ms_at_issue_rate": bounds["tight_trace_count"]["ops"]
                  / issue * 1e3},
        "nearest_static_10pct": {
            wide: {"steps_total": int(v[0].sum()),
                   "fires_total": int(v[1].sum()), "points": n_near}
            for wide, v in (("wide", roof_n[True]),
                            ("entry_exit", roof_n[False]))}}
    emit("dynamic_timings", card=card, end_to_end_ms=e2e,
         kernel_ms=kernel_ms, plain_ms=plain_ms, roofline=roof,
         bounds=bounds)
    replaces = {"wide_trace_count": "bvh_tpu/ops/trace.py:1199",
                "tight_trace_count": "bvh_tpu/ops/trace.py:677",
                "nearest_wide_count": "bvh_tpu/ops/nearest.py:476",
                "nearest_tight_count": "bvh_tpu/ops/nearest.py:228"}
    sources = {"wide_trace_count": "wide_trace.cu",
               "tight_trace_count": "tight_trace.cu",
               "nearest_wide_count": "nearest.cu",
               "nearest_tight_count": "nearest.cu"}
    entries = [{"name": name, "route": "cuda",
                "source": f"bvh_tpu_torch/csrc/{sources[name]}",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": holds[name]["max_abs_err"],
                "ms": kernel_ms[name], "plain_ms": plain_ms[name],
                "bound_ms": bounds[name]["bound_ms"],
                "bound_by": bounds[name]["bound_by"], "library_ms": None}
               for name in runs]
    # the FRAME builds: ms on the grid (LBVH) device build's aimed rows, the
    # nearest walks' on the far points' rows of the grid build
    for name_, src, replaces, kind in (
            ("wide_trace_frame", "wide_trace.cu", "trace.py:1178", "wide"),
            ("tight_trace_frame", "tight_trace.cu", "trace.py:650", "tight"),
            ("nearest_wide_frame", "nearest.cu", "nearest.py:349",
             "nearest_wide"),
            ("nearest_tight_frame", "nearest.cu", "nearest.py:214",
             "nearest_tight")):
        entries.append({
            "name": name_, "route": "cuda",
            "source": f"bvh_tpu_torch/csrc/{src}",
            "replaces": f"bvh_tpu/ops/{replaces}",
            "launches": launches[name_], "max_abs_err": frame_err[name_],
            "ms": frame_turns[kind]["frame"]["ms"],
            "plain_ms": frame_plain_ms[name_],
            "bound_ms": frame_bounds[name_]["bound_ms"],
            "bound_by": frame_bounds[name_]["bound_by"], "library_ms": None})
    keep = {"grid": dev_scenes["grid"], "far_rays": (fo_dev, fd_dev),
            "far_hits": dev_hits["far"], "far_points": fp_dev,
            "far_nearest": near_far[True], "chain": dev_chain,
            "chain_rays": (sao_dev, sad_dev, perm_s),
            "chain_hits": h, "chain_tris": sparse_dev}
    return entries, keep


# ---- phase 13, host builds: the exact frame on the main path ----------------

N_FAR_HOST = 1 << 20  # far aimed rays of each host leg
# the shared-edge rays the rounded frame missed, and their triangles (the
# reference's ids) on the tight walks
EDGE_RAYS = {374: 1365, 2843: 2960, 4003: 468}


def rounded(sc):
    """A scene (or chain) without its exact-frame table: the walks' builds
    without FRAME, a measuring run and never a path."""
    if hasattr(sc, "parts"):
        return sc._replace(parts=tuple(p._replace(a_lo=None)
                                       for p in sc.parts))
    return sc._replace(a_lo=None)


def host_frame_phase(dev, card: str, scene, scene_d, tris, o, d, ao, ad,
                     chain, chain_tris, issue: float,
                     n_sparse: int = 2 << 20) -> None:
    """Phase 13's host-build legs (ROADMAP queue 3 item 9): every scene the
    port builds carries ``a_lo``, so the walks test host builds' leaves in
    the exact frame too, where a ray whose origin lies ~1e5 from a leaf
    rounds ``o - cc``.

    Far legs: 1,048,576 ``far_aimed_rays`` (seed 17) through the 120k host
    build's group walk, its wide=False and packed=True builds and the
    legacy ClusterScene, and the sparse_1m host chain's own far rays; 4,096
    sampled of each against float64 brute force (0 flips), the same traces
    without ``a_lo`` counted beside (the legacy walk has no build without
    its float64 leaf test). The shared-edge case on host builds of
    create_n_cubes(500): 8,192 rays, every ray. The trace walks' counting
    FRAME builds on the aimed rows (against the timed build and the plain
    version) and the bounds from their counts; FRAME against without in
    turns, kernel and end to end, on the random, aimed, aimed_entry_exit,
    aimed_packed, camera W=128, nearest and sparse_1m legs. Phases 5, 7
    and 9 hold and time the FRAME builds that the main path launches."""
    a, b, c = tris
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris)
    sparse_dev = tuple(torch.from_numpy(x).to(dev) for x in chain_tris)
    t0 = time.perf_counter()
    scene_ee = build_tight_scene(a, b, c, wide=False)
    scene_pk = build_tight_scene(a, b, c, packed=True)
    legacy = build_cluster_scene(a, b, c)
    build_s = time.perf_counter() - t0
    check(all(x.a_lo is not None for x in (scene, scene_d, scene_ee, scene_pk,
                                          *chain.parts)),
          "a host build carries no a_lo")
    fo, fd = far_aimed_rays(a, b, c, N_FAR_HOST, seed=17)
    so, sd = far_aimed_rays(*chain_tris, N_FAR_HOST, seed=17)
    fo_dev, fd_dev, so_dev, sd_dev = (torch.from_numpy(x).to(dev)
                                      for x in (fo, fd, so, sd))
    perm_f, inv_f = sort_rays_device(fo_dev, fd_dev, mode="morton")
    perm_s, inv_s = sort_rays_device(so_dev, sd_dev, mode="morton")
    rays_f, rays_s = Ray.create(fo_dev, fd_dev), Ray.create(so_dev, sd_dev)

    def far_legs(frame: bool) -> dict:
        """Each far leg's t in ray order (``frame`` False: every scene
        without ``a_lo``; the legacy leg only with it)."""
        sc_ = (lambda x: x) if frame else rounded
        out = {leg: make_tracer(sc_(x), packet=8192, sort="morton",
                                tris=tris)(fo_dev, fd_dev).t
               for leg, x in (("host_group_far", scene),
                              ("host_entry_exit_far", scene_ee),
                              ("host_packed_far", scene_pk))}
        out["sparse_1m_far"] = trace_closest_hit_chained(
            sc_(chain), rays_s, tris=sparse_dev, packet=8192,
            perm=perm_s).t[inv_s]
        if frame:
            out["legacy_far"] = trace_closest_hit(
                legacy, rays_f.take(perm_f), tris=tris_dev).t[inv_f]
        return out

    # the host legs: every count zero before, read after
    obs.reset()
    hits = far_legs(True)
    torch.cuda.synchronize()
    launches = {"wide_trace_frame": n_launched("wide_trace.frame"),
                "tight_trace_frame": n_launched("tight_trace.frame"),
                "cluster_trace": n_launched("cluster_trace")}
    emit("host_frame_launches", **launches,
         wide_trace=n_launched("wide_trace"),
         tight_trace=n_launched("tight_trace"))
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the host far legs")
    check(n_launched("wide_trace.frame") == n_launched("wide_trace")
          and n_launched("tight_trace.frame") == n_launched("tight_trace"),
          "a host far leg's walk did not take the FRAME build")
    t_round = {k: v.cpu().numpy() for k, v in far_legs(False).items()}
    far = {}
    for i, (leg, t) in enumerate(hits.items()):
        sparse = leg.startswith("sparse")
        far[leg] = check_far_frame(
            leg, *((so, sd) if sparse else (fo, fd)), t.cpu().numpy(),
            sparse_dev if sparse else tris_dev, 60 + i, t_round.get(leg))
        if leg not in t_round:
            far[leg]["rounded_frame_flips_vs_f64"] = None

    # the shared-edge case on host builds, every ray against float64
    ea, eb, ec = tb.create_n_cubes(500)
    etris = tuple(torch.from_numpy(x).to(dev) for x in (ea, eb, ec))
    eo, ed = far_aimed_rays(ea, eb, ec, 8192, seed=17)
    e_rays = Ray.create(torch.from_numpy(eo).to(dev),
                        torch.from_numpy(ed).to(dev))
    e_tight = build_tight_scene(ea, eb, ec)
    e_scenes = {"group": e_tight, "entry_exit": e_tight,
                "packed": build_tight_scene(ea, eb, ec, packed=True),
                "chained": build_chained_scene(ea, eb, ec, max_part=2000),
                "legacy": build_cluster_scene(ea, eb, ec)}

    def edge_trace(kind, sc):
        if kind == "legacy":
            return trace_closest_hit(sc, e_rays, tris=etris)
        if kind == "chained":
            return trace_closest_hit_chained(sc, e_rays, tris=etris,
                                             packet=1024)
        return trace_closest_hit_tight(sc, e_rays, tris=etris, packet=1024,
                                       wide=kind == "group")

    edges = {}
    for kind, sc in e_scenes.items():
        h = edge_trace(kind, sc)
        t_r = (None if kind == "legacy"
               else edge_trace(kind, rounded(sc)).t.cpu().numpy())
        leg = f"host_shared_edges_{kind}"
        edges[leg] = check_far_frame(leg, eo, ed, h.t.cpu().numpy(), etris,
                                     0, t_r, sample=False)
        if t_r is None:
            edges[leg]["rounded_frame_flips_vs_f64"] = None
        named = list(EDGE_RAYS)
        check(bool(torch.isfinite(h.t[named]).all()),
              f"{leg}: ray 374, 2843 or 4003 missed")
        if kind != "legacy":
            ids = h.shape_id[named].tolist()
            check(ids == list(EDGE_RAYS.values()),
                  f"{leg}: rays 374, 2843, 4003 hit {ids}")
    emit("host_frame_far", card=card, build_s=build_s, far_legs=far,
         shared_edges=edges)

    # the host legs' rows (phases 5, 7 and 9 hold each FRAME build against
    # its plain version on them)
    t0 = time.perf_counter()
    o_dev, d_dev = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    ao_dev, ad_dev = torch.from_numpy(ao).to(dev), torch.from_numpy(ad).to(dev)
    oc_dev, dc_dev = (torch.from_numpy(x).to(dev) for x in dense_camera())
    rows_r = trace_rows(o_dev, d_dev, "octmorton")
    rows_a = trace_rows(ao_dev, ad_dev, "morton")
    rows_c = trace_rows(oc_dev, dc_dev, None)
    pr = torch.from_numpy(tb.create_rays(
        N_POINTS, seed=tb.seed_state_after(10007))[0]).to(dev)  # phase 7's
    prow = near_mod.point_rows(pr[sort_points_device(pr)[0]], None)

    def alo(sc, frame=True):
        return _dev(sc.a_lo, dev) if frame else None

    def table(sc):
        packed = sc.packed_nodes is not None
        return sc.packed_nodes if packed else sc.smem_nodes

    def wide_k(sc, rows, frame=True, **kw):
        return wide_mod.wide_trace(records(sc, dev), _dev(sc.groups, dev),
                                   rows, sc.width, sc.gdepth,
                                   a_lo=alo(sc, frame), **kw)

    def wide_p(sc, rows, **kw):
        return wide_plain_chunked(_dev(sc.gnodes, dev), _dev(sc.groups, dev),
                                  rows, sc.width, a_lo=alo(sc), **kw)

    def tight_k(sc, rows, frame=True, **kw):
        return tight_mod.tight_trace(
            node_recs(table(sc), dev), _dev(sc.groups, dev), rows, sc.width,
            packed=sc.packed_nodes is not None, a_lo=alo(sc, frame), **kw)

    def tight_p(sc, rows, **kw):
        return tight_plain_chunked(
            _dev(table(sc), dev), _dev(sc.groups, dev), rows, sc.width,
            packed=sc.packed_nodes is not None, a_lo=alo(sc), **kw)

    holds = {}
    # the counting FRAME builds on the aimed rows, and the bounds of the
    # aimed legs' FRAME walks from their counts
    n_a = rows_a.shape[1]
    bounds = {}
    for leg, kf, pf, sc, wide_ in (
            ("aimed", wide_k, wide_p, scene, True),
            ("aimed_entry_exit", tight_k, tight_p, scene_ee, False),
            ("aimed_packed", tight_k, tight_p, scene_pk, False)):
        hold = hold_counting_build(f"{leg}/count", kf(sc, rows_a, counts=True),
                                   kf(sc, rows_a),
                                   pf(sc, rows_a, counts=True))
        holds[f"{leg}_count"] = hold
        tab = records(sc, dev) if wide_ else node_recs(table(sc), dev)
        bounds[leg] = walk_bound(
            n_a, sc.width, hold["count_total"] / n_a,
            hold["fires_total"] / n_a, wide_,
            (wide_mod.N_ROWS * 4 + 16) * n_a + tab.nbytes + sc.groups.nbytes
            + sc.a_lo.nbytes, a.shape[0], frame=True)
        bounds[leg]["ops_ms_at_issue_rate"] = bounds[leg]["ops"] / issue * 1e3
    emit("host_frame_counts", card=card, seconds=time.perf_counter() - t0,
         holds=holds, bounds=bounds)

    # FRAME against without, in turns: each leg's kernel on its rows, then
    # end to end (the same entry point over the scene without a_lo)
    t0 = time.perf_counter()
    kernel = {
        leg: in_turns({"frame": lambda kf=kf, sc=sc, rows=rows: kf(sc, rows),
                       "without_frame": lambda kf=kf, sc=sc, rows=rows: kf(
                           sc, rows, frame=False)})
        for leg, (kf, sc, rows) in {
            "random": (wide_k, scene, rows_r),
            "aimed": (wide_k, scene, rows_a),
            "aimed_entry_exit": (tight_k, scene_ee, rows_a),
            "aimed_packed": (tight_k, scene_pk, rows_a),
            "camera_w128": (wide_k, scene_d, rows_c)}.items()}
    for kind in ("wide", "entry_exit"):
        kernel[f"nearest_{kind}"] = in_turns({
            "frame": lambda kind=kind: near_kernel(kind, scene, prow,
                                                   frame=True),
            "without_frame": lambda kind=kind: near_kernel(
                kind, scene, prow, frame=False)})
    co, cd = tb.create_rays(n_sparse, seed=tb.seed_state_after(84000))
    co_dev, cd_dev = torch.from_numpy(co).to(dev), torch.from_numpy(cd).to(dev)

    def sparse_1m(ch):
        perm, inv = sort_rays_device(co_dev, cd_dev, mode="octmorton")
        od = torch.cat([co_dev, cd_dev], dim=1)[perm]
        return trace_closest_hit_chained(
            ch, Ray.create(od[:, 0:3], od[:, 3:6]), packet=8192,
            sweep=False).t[inv]

    def tracer_pair(sc, od, dd, **kw):
        with_ = make_tracer(sc, **kw)
        without = make_tracer(rounded(sc), **kw)
        return (lambda: with_(od, dd)), (lambda: without(od, dd))

    pairs = {
        "random": tracer_pair(scene, o_dev, d_dev, packet=8192, sweep=False,
                              sort="octmorton"),
        "aimed": tracer_pair(scene, ao_dev, ad_dev, packet=8192,
                             sort="morton", tris=tris),
        "aimed_entry_exit": tracer_pair(scene_ee, ao_dev, ad_dev,
                                        packet=8192, sort="morton", tris=tris),
        "aimed_packed": tracer_pair(scene_pk, ao_dev, ad_dev, packet=8192,
                                    sort="morton", tris=tris),
        "camera_w128": tracer_pair(scene_d, oc_dev, dc_dev, packet=4096,
                                   sweep=False, sort=None),
        "nearest_random": (lambda: nearest_tight(scene, pr),
                           lambda: nearest_tight(rounded(scene), pr)),
        "sparse_1m": (lambda: sparse_1m(chain),
                      lambda: sparse_1m(rounded(chain)))}
    e2e = {leg: in_turns({"frame": fw, "without_frame": fo_})
           for leg, (fw, fo_) in pairs.items()}
    for v in list(kernel.values()) + list(e2e.values()):
        v["ratio"] = v["frame"]["ms"] / v["without_frame"]["ms"]
    emit("host_frame_turns", card=card, seconds=time.perf_counter() - t0,
         kernel=kernel, end_to_end=e2e, bounds=bounds,
         legacy="no build without the float64 leaf test: kernel_ab.py times "
                "the earlier walk against this one")


# ---- phase 14: the general pure-tensor path ---------------------------------

N_QUERIES = 1 << 16  # queries of the traverse and ordered legs
N_GENERAL_POINTS = 1 << 18  # points of the nearest leg
# lock-step steps above which a leg's profile is not taken: ~130 kernel
# records a step, and the profiler's processing of ~5e5 records (3,776
# steps of the nearest leg) took longer than the leg's 60 s on an H100
PROFILE_MAX_STEPS = 1000
N_COLLECT = 256  # queries a leg checks against brute_force_collect


def general_call(fn):
    """One call of ``fn``, synchronized: its result, and its lock-step steps
    and host reads (``bvh/traverse.py``'s counters) and seconds."""
    steps = obs.counted("traverse.steps")
    reads = obs.counted("traverse.host_reads")
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"steps": obs.counted("traverse.steps") - steps,
                 "host_reads": obs.counted("traverse.host_reads") - reads,
                 "first_call_s": time.perf_counter() - t0}


def general_idle(fn, e2e_ms: float, steps: int) -> dict:
    """The idle share of one call of ``fn``, a general-path leg that was
    already run (no warm-up call): its device time (torch.profiler, device
    events only) against the call's unprofiled time ``e2e_ms``; not
    measured for a call of more than PROFILE_MAX_STEPS lock-step
    steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if steps > PROFILE_MAX_STEPS:
        return {"kernels_ms": "not measured", "idle_share": "not measured",
                "reason": f"{steps} lock-step steps (PROFILE_MAX_STEPS)"}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        return {"kernels_ms": "not measured", "idle_share": "not measured"}
    busy = sum(e.self_device_time_total for e in events) / 1e3
    return {"kernels_ms": busy, "e2e_ms": e2e_ms,
            "idle_share": 1.0 - busy / e2e_ms,
            "launches": sum(e.count for e in events)}


def collect_mask(hits, count, n_shapes: int):
    """A traverse's hit lists as a bool mask [queries, n_shapes]."""
    m = torch.zeros((hits.shape[0], n_shapes), dtype=torch.bool,
                    device=hits.device)
    r, k = torch.nonzero(hits >= 0, as_tuple=True)
    m[r, hits[r, k].long()] = True
    return m


def f64_scene():
    """tests/test_f64_2d.py's float64 scene: create_n_cubes(40) and two
    triangles 1e-9 apart at x = 2e5, with its two rays at them and 16 rays
    aimed at cubes (seed 7), numpy float64."""
    rng = np.random.default_rng(7)
    a, b, c = (x.astype(np.float64) for x in tb.create_n_cubes(40))
    base = np.array([[0.0, 0.0, 0.0], [0.0, 4.0, 0.0], [0.0, 0.0, 4.0]])
    sh = np.array([[2e5, 0, 0], [2e5 + 1e-9, 0, 0]])
    a, b, c = (np.concatenate([x, base[k] + sh])
               for k, x in enumerate((a, b, c)))
    o = rng.uniform(-500, 500, size=(16, 3))
    centers = a[:40 * 12].reshape(-1, 12, 3).mean(axis=1)
    d = centers[rng.integers(0, 40, size=16)] + 0.1 - o
    o = np.concatenate([[[2e5 + 50.0, 1.0, 1.0]] * 2, o])
    d = np.concatenate([[[-1.0, 0.0, 0.0]] * 2, d])
    return (a, b, c), o, d


def general_phase(dev, card: str, scene, tris, ao, ad, h_aim, pts) -> dict:
    """Phase 14: the general pure-tensor path at full size on the 120k
    scene as a ``build_sah`` FlatBvh (239,999 nodes): closest hit on the
    aimed rays (against brute force and make_tracer's trace), any hit on
    the shadow rows (t_max = 1.2x the hit; against trace_any_hit_tight),
    nearest triangle on 262,144 of phase 7's points (against brute force
    and nearest_tight), traverse with ray, box and ball queries (against
    brute_force_collect), nearest_traverse, render_depth forward and
    backward (against render_depth_fast) and a float64 closest hit
    (against float64 brute force); each timed, with its lock-step steps,
    host reads and idle share."""
    a, b, c = tris
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris)
    n_tris = a.shape[0]
    mn, mx = tb.tri_aabbs(a, b, c)
    t0 = time.perf_counter()
    flat_h, _ = build_sah(mn, mx)
    build_s = time.perf_counter() - t0
    flat = flat_h.to_device(device=dev)
    check(flat.num_nodes == 2 * n_tris - 1, "general path: SAH node count")
    mn_dev, mx_dev = torch.from_numpy(mn).to(dev), torch.from_numpy(mx).to(dev)
    ao_dev, ad_dev = torch.from_numpy(ao).to(dev), torch.from_numpy(ad).to(dev)
    rays = Ray.create(ao_dev, ad_dev)
    n = rays.origin.shape[0]
    tm = h_aim.t * 1.2  # the shadow rows; misses keep +inf
    q_rays = Ray(*(x[:N_QUERIES] for x in rays))
    rng = np.random.default_rng(31)
    cen = (a + b + c) / np.float32(3)
    pq = (cen[rng.integers(0, n_tris, N_QUERIES)]
          + rng.normal(scale=2.0, size=(N_QUERIES, 3))).astype(np.float32)
    pq_dev = torch.from_numpy(pq).to(dev)
    queries = {
        "ray": RayQuery(q_rays),
        "aabb": AabbQuery(Aabb.with_bounds(pq_dev - 3.0, pq_dev + 3.0,
                                           device=dev)),
        "ball": BallQuery(Ball.create(pq_dev, torch.full(
            (N_QUERIES,), 4.0, device=dev), device=dev))}
    pts_n = pts[:N_GENERAL_POINTS]
    (a64, b64, c64), o64, d64 = f64_scene()
    mn64, mx64 = tb.tri_aabbs(a64, b64, c64)
    flat64 = build_sah(mn64, mx64)[0].to_device(device=dev)
    tris64 = tuple(torch.from_numpy(x).to(dev) for x in (a64, b64, c64))
    rays64 = Ray.create(o64, d64, device=dev)
    check(rays64.origin.dtype == torch.float64, "f64 rays")
    perm, _ = sort_rays_device(ao_dev, ad_dev, mode="morton")
    aimed = Ray.create(ao_dev[perm], ad_dev[perm])

    def fwd_bwd(render, w):
        """bench.py's diff_fwd_bwd loss over the hits ``w`` selects, and its
        gradients with respect to a, b and c."""
        av, bv, cv = (x.detach().requires_grad_() for x in tris_dev)
        depth, hit = render(aimed, av, bv, cv)
        loss = torch.where(hit & w, depth ** 2, 0.0).sum() * 1e-9
        loss.backward()
        return loss.detach(), depth.detach(), hit, (av.grad, bv.grad, cv.grad)

    def general(r, *t):
        return render_depth(flat, r, *t)

    def fast(r, *t):
        return render_depth_fast(scene, r, *t, packet=8192)

    every = torch.ones(n, dtype=torch.bool, device=dev)
    legs = {
        "closest_hit_triangles": lambda: closest_hit_triangles(
            flat, rays, *tris_dev),
        "any_hit_triangles": lambda: any_hit_triangles(flat, rays, *tris_dev,
                                                       t_max=tm),
        "nearest_to_triangles": lambda: nearest_to_triangles(flat, pts_n,
                                                             *tris_dev),
        "traverse_ray": lambda: traverse_all(flat, queries["ray"]),
        "traverse_aabb": lambda: traverse_all(flat, queries["aabb"]),
        "traverse_ball": lambda: traverse_all(flat, queries["ball"]),
        "nearest_traverse": lambda: nearest_traverse(flat, q_rays,
                                                     max_hits=32),
        "render_depth_fwd_bwd": lambda: fwd_bwd(general, every),
        "closest_hit_f64": lambda: closest_hit_triangles(flat64, rays64,
                                                         *tris64)}
    # the phase's main path: the general path launches none of the port's
    # kernels (the reference computes it outside any Pallas kernel)
    obs.reset()
    out, counts = {}, {}
    for leg, fn in legs.items():
        out[leg], counts[leg] = general_call(fn)
    check(port_launches() == 0, "the general path launched a port kernel")

    # ---- checks ----------------------------------------------------------
    checks = {}
    h = out["closest_hit_triangles"]
    check(h.t.shape == (n,) and bool(((h.shape_id >= 0)
                                      == torch.isfinite(h.t)).all()),
          "closest_hit_triangles: shapes or ids")
    checks["closest_brute"] = check_vs_brute(
        "general_closest", ao, ad, h.t.cpu().numpy(), tris_dev, 60)
    diffs, outside = classify_differences(h, h_aim, int(scene.width))
    check(outside == 0, f"closest_hit_triangles differs from make_tracer on "
          f"{outside} rays outside the near-tie and grazing-edge classes")
    checks["closest_vs_make_tracer"] = {
        "differing": len(diffs), "classes": {
            k: sum(x["class"] == k for x in diffs)
            for k in ("near-tie", "grazing-edge")}}
    occ = trace_any_hit_tight(scene, rays, t_max=tm, packet=8192)
    found = out["any_hit_triangles"]
    agree = float((occ == found).float().mean())
    checks["any_vs_trace_any_hit_tight"] = {
        "agreement": agree, "differing": int((occ != found).sum()),
        "occluded_fraction": float(found.float().mean())}
    check(agree >= 0.9999, f"any_hit_triangles: {checks['any_vs_trace_any_hit_tight']}")
    sid_g, dist_g = out["nearest_to_triangles"]
    checks["nearest_brute"] = check_nearest_vs_brute(
        "general_nearest", pts_n, sid_g, dist_g, tris_dev, 61)
    sid_k, dist_k = nearest_tight(scene, pts_n)
    dif = torch.nonzero((sid_g != sid_k) | (dist_g != dist_k))[:, 0]
    check(ties_only(pts_n[dif], sid_g[dif], dist_g[dif], sid_k[dif],
                    dist_k[dif], tris_dev),
          "nearest_to_triangles differs from nearest_tight outside the tie "
          "class")
    checks["nearest_vs_nearest_tight"] = {
        "ids_differ": int((sid_g != sid_k).sum()),
        "distance_bits_differ": int((dist_g != dist_k).sum()),
        "max_abs_distance_diff": float((dist_g - dist_k).abs().max())}
    sample = torch.from_numpy(np.random.default_rng(62).choice(
        N_QUERIES, N_COLLECT, replace=False)).to(dev)
    for kind, q in queries.items():
        hits, cnt = out[f"traverse_{kind}"]
        qs = trav_mod._take(q, sample, N_QUERIES)
        want = brute_force_collect(qs, mn_dev, mx_dev)
        got = collect_mask(hits[sample], cnt[sample], n_tris)
        check(torch.equal(got, want) and torch.equal(
            cnt[sample].long(), want.sum(1)),
            f"traverse {kind}: differs from brute_force_collect")
        checks[f"traverse_{kind}"] = {
            "sampled": N_COLLECT, "mean_count": float(cnt.float().mean()),
            "max_count": int(cnt.max()), "buffer": int(hits.shape[1])}
    ids, dist, cnt = out["nearest_traverse"]
    hits_r, cnt_r = out["traverse_ray"]
    fits = cnt_r <= 32
    check(torch.equal(cnt, cnt_r) and torch.equal(
        collect_mask(ids[fits], cnt[fits], n_tris),
        collect_mask(hits_r[fits], cnt_r[fits], n_tris)),
        "nearest_traverse: its shapes differ from traverse's")
    fin = torch.isfinite(dist[:, 1:]) & torch.isfinite(dist[:, :-1])
    check(bool((dist[:, 1:] >= dist[:, :-1])[fin].all()),
          "nearest_traverse: distances not ascending")
    checks["nearest_traverse"] = {"rays": N_QUERIES,
                                  "overflowing": int((~fits).sum())}
    # render_depth against render_depth_fast: equal depth outside the
    # classes; gradients of the loss over the rays both hit on the same
    # triangle within DIFF_GRAD_RTOL of the largest. render_hits_fast keeps
    # the walk's hit where its float32 recompute puts the ray a rounding
    # outside the triangle the exact frame took, so a ray across a shared
    # edge is a near tie or a grazing edge here, never a miss on one side
    with torch.no_grad():
        hg = render_hits(flat, aimed, *tris_dev)
        hf = render_hits_fast(scene, aimed, *tris_dev, packet=8192)
    diffs, outside = classify_differences(hg, hf, int(scene.width))
    check(outside == 0, f"render_depth differs from render_depth_fast on "
          f"{outside} rays outside the classes: "
          f"{[x for x in diffs if x['class'] == 'outside'][:8]}")
    same = hg.shape_id == hf.shape_id
    loss_g, depth_g, hit_g, grads_g = out["render_depth_fwd_bwd"]
    check(torch.equal(torch.where(hit_g, depth_g, float("inf")), hg.t),
          "render_depth: depth differs from render_hits")
    _, _, _, g_gen = fwd_bwd(general, same)
    _, _, _, g_fast = fwd_bwd(fast, same)
    grad_err = []
    for g, gf in zip(g_gen, g_fast):
        scale, e = float(gf.abs().max()), float((g - gf).abs().max())
        grad_err.append({"max_abs_diff": e, "max_abs": scale})
        check(bool(torch.isfinite(g).all()) and e <= DIFF_GRAD_RTOL * scale,
              f"render_depth: gradients differ from render_depth_fast by {e} "
              f"(largest {scale})")
    checks["render_depth_vs_fast"] = {
        "differing": len(diffs),
        "classes": {k: sum(x["class"] == k for x in diffs)
                    for k in ("near-tie", "grazing-edge")},
        "edge_rays": [x for x in diffs
                      if x["shape_id"][0] != x["shape_id"][1]][:32],
        "rays_in_gradients": int(same.sum()), "gradients": grad_err}
    h64 = out["closest_hit_f64"]
    w64 = brute_force_closest_hit(rays64, *tris64)
    rel64 = float(((h64.t - w64.t).abs() / w64.t.abs())[torch.isfinite(
        w64.t)].max())
    check(h64.t.dtype == torch.float64 and torch.equal(
        torch.isfinite(h64.t), torch.isfinite(w64.t)) and rel64 <= 1e-12
        and int(h64.shape_id[0]) == a64.shape[0] - 1
        and abs(float(h64.t[0]) - (50.0 - 1e-9)) < 1e-9,
        f"closest_hit f64: rel err {rel64}, ids {h64.shape_id[:2].tolist()}")
    checks["closest_hit_f64"] = {"rays": int(o64.shape[0]),
                                 "max_rel_t_err": rel64,
                                 "t_near_pair": float(h64.t[0])}
    emit("general_path", card=card, sah_nodes=int(flat.num_nodes),
         sah_build_s=build_s, checks=checks, calls=counts)

    # ---- timings ------------------------------------------------------------
    units = {"closest_hit_triangles": ("rays", n),
             "any_hit_triangles": ("rays", n),
             "nearest_to_triangles": ("points", N_GENERAL_POINTS),
             "traverse_ray": ("queries", N_QUERIES),
             "traverse_aabb": ("queries", N_QUERIES),
             "traverse_ball": ("queries", N_QUERIES),
             "nearest_traverse": ("rays", N_QUERIES),
             "render_depth_fwd_bwd": ("rays", n),
             "closest_hit_f64": ("rays", int(o64.shape[0]))}
    # each leg ran once above (its warm-up); 7 timed calls and a profile
    timings = {}
    for leg, fn in legs.items():
        t0 = time.perf_counter()
        ms = cuda_ms(fn, warmup=0)
        unit, count = units[leg]
        timings[leg] = {"ms": ms, f"{unit}_per_s": count / (ms * 1e-3),
                        **counts[leg],
                        "breakdown": general_idle(fn, ms,
                                                  counts[leg]["steps"])}
        timings[leg]["leg_s"] = time.perf_counter() - t0
        check(timings[leg]["leg_s"] <= 60.0, f"{leg}: over 60 s")
    emit("general_timings", card=card, legs=timings)
    return timings


# ---- phase 15: io -------------------------------------------------------------

def obj_text(a, b, c, quads: bool = False) -> str:
    """``create_n_cubes``' triangles (a, b, c; 12 a cube) as Wavefront OBJ
    text, each cube's 8 corners once as ``v`` lines (9 significant digits,
    which give the float32 values back). Triangles: every cube's faces as
    ``f`` lines of three indices, absolute on even cubes and relative
    (negative) on odd ones, every third cube with ``i//i`` tokens; the
    loader gives a, b and c back. ``quads``: each of a cube's six faces as
    one quad (p0, p1, p2, p3) of its triangle pair (p0, p1, p2), (p2, p3,
    p0), by negative indices: the loader's fan gives the first triangle
    and the second as (p0, p2, p3), the same triangle from another
    vertex."""
    n = a.shape[0] // 12
    v = np.stack([a, b, c], axis=1).reshape(n, 36, 3)
    off = v[0] - v[0, 0]  # the cube's corner offsets, the same for every cube
    _, first, slot = np.unique(np.round(off), axis=0, return_index=True,
                               return_inverse=True)
    slot = slot.reshape(12, 3)
    corners = v[:, first]  # [n, 8, 3]
    check(np.array_equal(corners[:, slot.reshape(-1)], v),
          "obj: a cube's triangles are not made of its 8 corners")
    if quads:
        check(np.array_equal(slot[1::2, 0], slot[0::2, 2])
              and np.array_equal(slot[1::2, 2], slot[0::2, 0]),
              "obj: a cube's triangle pairs are not (p0 p1 p2), (p2 p3 p0)")
        faces = np.concatenate([slot[0::2], slot[1::2, 1:2]], axis=1)
    else:
        faces = slot
    vlines = np.char.add("v ", np.char.add(np.char.add(
        np.char.mod("%.9g ", corners[..., 0]), np.char.mod(
            "%.9g ", corners[..., 1])), np.char.mod("%.9g", corners[..., 2])))
    out = ["# create_n_cubes(%d) as OBJ text" % n]
    for k in range(n):
        out.extend(vlines[k])
        if quads or k % 2:
            idx = faces - 8  # relative: this cube's corners are the last 8
        else:
            idx = faces + 8 * k + 1
        tok = idx.astype(str)
        if k % 3 == 0:
            tok = np.char.add(np.char.add(tok, "//"), tok)
        out.extend("f " + " ".join(row) for row in tok)
    return "\n".join(out) + "\n"


def io_phase(dev, card: str, scene, tris, ao_dev, ad_dev, h_aim,
             keep: dict) -> dict:
    """Phase 15: ``bvh_tpu_torch.io``. create_n_cubes(10000) written as OBJ
    text and loaded (the generator's arrays), built (phase 3's tables) and
    traced on the aimed rays (phase 3's aimed leg bit for bit); its first
    1,000 cubes as quads (the fan's triangles); the 120k host scene, the
    grid device build (with ``a_lo``) and phase 13's 1M chained device
    build saved and loaded in a temporary directory: tables equal, the
    far-frame rows' traces and nearest queries and the chain's aimed trace
    equal before and after bit for bit, the FRAME builds launched on the
    loaded scenes."""
    a, b, c = tris
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "cubes.obj")
        with open(path, "w") as fh:
            fh.write(obj_text(a, b, c))
        path_q = os.path.join(tmp, "quads.obj")
        with open(path_q, "w") as fh:
            fh.write(obj_text(a[:12000], b[:12000], c[:12000], quads=True))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        la, lb, lc = load_obj_triangles(path)
        load_s = time.perf_counter() - t0
        check(all(np.array_equal(x, y) and x.dtype == np.float32
                  for x, y in zip((la, lb, lc), (a, b, c))),
              "obj: the loaded triangles are not the generator's")
        qa, qb, qc = load_obj_triangles(path_q)
        fan = (np.array_equal(qa[0::2], a[:12000:2])
               and np.array_equal(qb[0::2], b[:12000:2])
               and np.array_equal(qc[0::2], c[:12000:2])
               and np.array_equal(qa[1::2], c[1:12000:2])
               and np.array_equal(qb[1::2], a[1:12000:2])
               and np.array_equal(qc[1::2], b[1:12000:2]))
        check(fan, "obj: the quads' fan triangles are not the generator's")
        t0 = time.perf_counter()
        sc_obj = build_tight_scene(la, lb, lc)
        build_s = time.perf_counter() - t0
        check(scenes_equal(sc_obj, scene),
              "obj: the scene built from the OBJ differs from phase 3's")
        h_obj = make_tracer(sc_obj, packet=8192, sort="morton",
                            tris=(la, lb, lc))(ao_dev, ad_dev)
        check(records_equal(h_obj, h_aim),
              "obj: the aimed trace differs from phase 3's aimed leg")
        res["obj"] = {"triangles": int(la.shape[0]),
                      "bytes": os.path.getsize(path), "write_s": write_s,
                      "load_s": load_s, "build_s": build_s,
                      "quad_triangles": int(qa.shape[0]),
                      "tables_equal": True, "aimed_equal": True}

        def round_trip(name, obj, save, load):
            p = os.path.join(tmp, f"{name}.npz")
            t1 = time.perf_counter()
            save(p, obj)
            t2 = time.perf_counter()
            back = load(p)
            t3 = time.perf_counter()
            res[name] = {"save_s": t2 - t1, "load_s": t3 - t2,
                         "bytes": os.path.getsize(p)}
            return back

        back = round_trip("host_120k", scene, save_tight_scene,
                          load_tight_scene)
        check(scenes_equal(back, scene), "io: the host scene changed")
        grid = keep["grid"]
        back_g = round_trip("grid_device_120k", grid, save_tight_scene,
                            load_tight_scene)
        check(back_g.a_lo is not None and scenes_equal(back_g, grid),
              "io: the grid device build changed")
        fo_dev, fd_dev = keep["far_rays"]
        before = (n_launched("wide_trace.frame"),
                  n_launched("nearest_wide.frame"))
        h_far = make_tracer(back_g, packet=8192, sort="morton",
                            tris=tris)(fo_dev, fd_dev)
        near_far = nearest_tight(back_g, keep["far_points"])
        torch.cuda.synchronize()
        launched = (n_launched("wide_trace.frame") - before[0],
                    n_launched("nearest_wide.frame") - before[1])
        check(min(launched) > 0, "io: the loaded device build did not run "
                                 "the FRAME builds")
        check(bits_equal(h_far.t, keep["far_hits"]),
              "io: the far-frame trace changed across the round trip")
        check(all(bits_equal(x, y) for x, y in zip(near_far,
                                                   keep["far_nearest"])),
              "io: the far-frame nearest query changed across the round "
              "trip")
        res["grid_device_120k"].update(frame_launches=list(launched),
                                       far_trace_equal=True,
                                       far_nearest_equal=True)
        chain = keep["chain"]
        back_c = round_trip("chain_device_1m", chain, save_chained_scene,
                            load_chained_scene)
        check(len(back_c.parts) == len(chain.parts)
              and all(scenes_equal(x, y)
                      for x, y in zip(back_c.parts, chain.parts))
              and all(bits_equal(x, y)
                      for x, y in zip(back_c.orig_ids, chain.orig_ids)),
              "io: the chained device build changed")
        sao_dev, sad_dev, perm_s = keep["chain_rays"]
        h_c = trace_closest_hit_chained(back_c, Ray.create(sao_dev, sad_dev),
                                        tris=keep["chain_tris"], packet=8192,
                                        perm=perm_s)
        check(records_equal(h_c, keep["chain_hits"]),
              "io: the chain's aimed trace changed across the round trip")
        res["chain_device_1m"].update(parts=len(chain.parts),
                                      aimed_trace_equal=True)
    return res


# ---- phase 16: parallel ----------------------------------------------------

N_DEPTH_RAYS = 1 << 18  # the depth and training legs' aimed rays
LOSS_RTOL = 1e-5  # the sharded loss against the unsharded mean
# the training leg: lr per ray (the gradient of a mean carries 1/n), at
# which the first step moves the hit triangles' vertices, ~5e4 from the
# origin (an ulp 0.004-0.008), by a median of ~13 ulps; the depth of a
# miss is the aimed rays' start distance from their cube (tb.aimed_rays),
# so a ray that passes through a crack opened between a cube's moved faces
# costs about what a hit costs, not a residual of ~50
TRAIN_LR_PER_RAY = 0.03
TRAIN_BACKGROUND = 50.0
TRAIN_MIN_MEDIAN_ULPS = 8  # the moved coordinates' median move, at least
# loss1 against the unsharded step's: the sums' grouping differs, and a
# vertex an ulp apart may move one ray between a hit and a miss
TRAIN_LOSS_RTOL = 1e-4


def parallel_phase(dev, card: str, scene, tris, o_dev, d_dev, ao_dev,
                   ad_dev, h_aim) -> dict:
    """Phase 16: ``bvh_tpu_torch.parallel`` at world size 1 on the card
    (NCCL over a single-rank group): the ray-sharded traces against the
    unsharded calls (bit for bit, timed in turns), the scaling report, and
    the scene-sharded depth, gradients and training step against the
    unsharded general path."""
    import torch.distributed as dist

    from bvh_tpu_torch.parallel import (make_mesh, make_multihost_mesh,
                                        multihost_trace_closest_hit,
                                        ray_scaling_report, shard_scene,
                                        sharded_loss_and_grads,
                                        sharded_render_depth,
                                        sharded_trace_any_hit,
                                        sharded_trace_closest_hit,
                                        sharded_train_step)

    a, b, c = tris
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris)
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and mesh.size() == 1,
          "parallel: not a one-rank NCCL mesh")
    rays_r, rays_a = Ray.create(o_dev, d_dev), Ray.create(ao_dev, ad_dev)
    tm = h_aim.t * 1.2  # phase 3's aimed hits: the shadow rows
    scene_g = build_tight_scene_device(*tris_dev)
    scene_ee = build_tight_scene(a, b, c, wide=False)
    multi = make_multihost_mesh()
    P = 8192
    legs = {
        "closest_random": (
            lambda: sharded_trace_closest_hit(mesh, scene, rays_r, packet=P),
            lambda: trace_closest_hit_tight(scene, rays_r, packet=P)),
        "closest_aimed_tris": (
            lambda: sharded_trace_closest_hit(mesh, scene, rays_a, tris=tris,
                                              packet=P),
            lambda: trace_closest_hit_tight(scene, rays_a, tris=tris,
                                            packet=P)),
        "closest_aimed_device_build": (
            lambda: sharded_trace_closest_hit(mesh, scene_g, rays_a,
                                              tris=tris_dev, packet=P),
            lambda: trace_closest_hit_tight(scene_g, rays_a, tris=tris_dev,
                                            packet=P)),
        "any_shadow": (
            lambda: sharded_trace_any_hit(mesh, scene, rays_a, t_max=tm,
                                          packet=P),
            lambda: trace_any_hit_tight(scene, rays_a, t_max=tm, packet=P)),
        "any_shadow_entry_exit": (
            lambda: sharded_trace_any_hit(mesh, scene_ee, rays_a, t_max=tm,
                                          packet=P),
            lambda: trace_any_hit_tight(scene_ee, rays_a, t_max=tm,
                                        packet=P)),
        "multihost_aimed": (
            lambda: multihost_trace_closest_hit(multi, scene, rays_a,
                                                packet=P),
            lambda: trace_closest_hit_tight(scene, rays_a, packet=P))}
    # the phase's main path: every count zero before, read after
    obs.reset()
    got = {leg: sharded() for leg, (sharded, _) in legs.items()}
    torch.cuda.synchronize()
    launches = {"wide_trace": n_launched("wide_trace"),
                "wide_trace_any": n_launched("wide_trace.any"),
                "wide_trace_frame": n_launched("wide_trace.frame"),
                "tight_trace": n_launched("tight_trace")}
    emit("parallel_main_path_launches", **launches)
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on phase 16's main path")
    equal = {}
    for leg, (_, plain) in legs.items():
        want = plain()
        same = (records_equal(got[leg], want) if isinstance(want, tuple)
                else torch.equal(got[leg], want))
        check(same, f"parallel {leg}: the sharded result differs from the "
                    "unsharded call's")
        equal[leg] = same
    check(bool(torch.isfinite(got["closest_aimed_tris"].t).float().mean()
               >= 0.999), "parallel: aimed hit fraction below 0.999")
    turns = {leg: in_turns({"sharded": sh, "unsharded": un}, rounds=1)
             for leg, (sh, un) in legs.items()}
    for v in turns.values():
        v["ratio"] = v["sharded"]["ms"] / v["unsharded"]["ms"]
    # where the sharded calls' extra time goes: device time by kernel and
    # the idle share, sharded and unsharded
    breakdown = {f"{leg}/{kind}": device_breakdown(
        legs[leg][i], turns[leg][kind]["ms"])
        for leg in ("closest_random", "any_shadow")
        for i, kind in enumerate(("sharded", "unsharded"))}
    report = ray_scaling_report(scene, rays_r, shard_counts=(1,), packet=P)
    check(set(report) == {1} and report[1]["efficiency"] == 1.0,
          f"parallel: scaling report {report}")

    # ---- depth, gradients, training on shard_scene(..., 1) -------------
    n = N_DEPTH_RAYS
    rays_d = Ray(*(x[:n] for x in rays_a))
    st, sa, sb, sc_ = shard_scene(a, b, c, 1)
    t0 = time.perf_counter()
    depth, gid = sharded_render_depth(mesh, st, sa, sb, sc_, rays_d)
    flat = FlatBvh(*(torch.as_tensor(x[0]).to(dev) for x in st))
    ref, hit = render_depth(flat, rays_d, *tris_dev)
    single = closest_hit_triangles(flat, rays_d, *tris_dev)
    check(bits_equal(depth, ref) and torch.equal(gid >= 0, hit)
          and torch.equal(gid, single.shape_id),
          "parallel: sharded_render_depth differs from render_depth")
    bf = check_vs_brute("parallel_depth", *(x[:n].cpu().numpy()
                                            for x in (ao_dev, ad_dev)),
                        torch.where(hit, depth, float("inf")).cpu().numpy(),
                        tris_dev, 70)
    target = depth + 0.5
    loss, grads = sharded_loss_and_grads(mesh, (sa, sb, sc_), st, rays_d,
                                         target)
    verts = tuple(x.clone().requires_grad_(True) for x in tris_dev)
    d_u, _ = render_depth(flat, rays_d, *verts)
    loss_u = ((d_u - target) ** 2).mean()
    loss_u.backward()
    grad_err = []
    for g, v in zip(grads, verts):
        scale = float(v.grad.abs().max())
        e = float((g.reshape(-1, 3) - v.grad).abs().max())
        grad_err.append({"max_abs_diff": e, "max_abs": scale})
        check(e <= DIFF_GRAD_RTOL * scale,
              f"parallel: gradients differ from the unsharded autograd's by "
              f"{e} (largest {scale})")
    # the two losses sum the same squares in another grouping (hits and
    # misses apart) over 262,144 rays
    check(abs(float(loss) - float(loss_u.detach())) <= LOSS_RTOL * float(
        loss_u.detach()), f"parallel: loss {float(loss)} against "
        f"{float(loss_u.detach())}")
    # two training steps, the first held against the unsharded autograd
    # step v - lr * grad on the same vertices
    lr, bg, target = TRAIN_LR_PER_RAY * n, TRAIN_BACKGROUND, depth + 0.25
    verts_s, losses, steps = (sa, sb, sc_), [], []
    for _ in range(2):
        lo, verts_s = sharded_train_step(mesh, verts_s, st, rays_d, target,
                                         lr=lr, background=bg)
        losses.append(float(lo))
        steps.append(verts_s)
    check(abs(losses[0] - 0.0625) <= 1e-3 * 0.0625 and losses[1] < losses[0],
          f"parallel: training losses {losses}")
    verts = tuple(x.clone().requires_grad_(True) for x in tris_dev)
    d_u, _ = render_depth(flat, rays_d, *verts, background=bg)
    ((d_u - target) ** 2).mean().backward()
    v_u = tuple((v - lr * v.grad).detach() for v in verts)
    v_s = tuple(x.reshape(-1, 3) for x in steps[0])
    tol = lr * DIFF_GRAD_RTOL * max(float(v.grad.abs().max()) for v in verts)
    v0 = torch.cat(tris_dev)
    ulp = (torch.nextafter(v0, torch.full_like(v0, float("inf"))) - v0).abs()
    move = (torch.cat(v_s) - v0).abs()
    off = (torch.cat(v_s) - torch.cat(v_u)).abs()
    moved = move > 0
    median_ulps = float((move[moved] / ulp[moved]).median())
    check(bool((off <= tol + ulp).all()),
          f"parallel: the step's vertices differ from v - lr * grad of the "
          f"unsharded autograd by up to {float(off.max())} (tolerance "
          f"{tol} + an ulp)")
    check(median_ulps >= TRAIN_MIN_MEDIAN_ULPS,
          f"parallel: the step moved vertices by a median of {median_ulps} "
          f"ulps")
    d_u1, _ = render_depth(flat, rays_d, *v_u, background=bg)
    loss_u1 = float(((d_u1 - target) ** 2).mean())
    check(abs(losses[1] - loss_u1) <= TRAIN_LOSS_RTOL * loss_u1,
          f"parallel: loss1 {losses[1]} against the unsharded step's "
          f"{loss_u1}")
    train = {"lr": lr, "background": bg, "losses": losses,
             "loss1_unsharded": loss_u1,
             "coordinates_moved": int(moved.sum()),
             "median_move_ulps": median_ulps,
             "max_move": float(move.max()),
             "max_off_unsharded": float(off.max()), "tolerance": tol}
    depth_s = time.perf_counter() - t0
    dist.destroy_process_group()
    return {"card": card, "launches": launches, "equal_to_unsharded": equal,
            "in_turns": turns, "breakdown": breakdown,
            "scaling_report": report,
            "depth": {"rays": n, "hit_fraction": float(hit.float().mean()),
                      "brute_force": bf, "equal_to_render_depth": True},
            "loss": float(loss), "loss_unsharded": float(loss_u.detach()),
            "gradients": grad_err, "train": train,
            "depth_legs_s": depth_s}


# ---- phase 17: bench.py's scales and ray_aabb_1000 legs ---------------------

SCALES = (100, 1000)  # create_n_cubes counts of the scale legs: 1.2k, 12k tris
N_SCALE_RAYS = 2 << 20  # bench.py's n_rays
N_SLAB_BOXES = 1000  # ray_aabb_1000: the boxes of the first 1,000 triangles
N_SLAB_RAYS = 1 << 17  # of create_n_cubes(84), against 131,072 rays


def scale_scene(nc: int):
    """A scale leg's scene (create_n_cubes(nc), host build), its triangles
    and bench.py's rays for it, numpy."""
    a, b, c = tb.create_n_cubes(nc)
    o, d = tb.create_rays(N_SCALE_RAYS, seed=tb.seed_state_after(nc))
    return build_tight_scene(a, b, c), (a, b, c), o, d


def phase_scales_kernels(dev, n: int = 65536) -> dict:
    """Phase 2's scale leg: the group walk (ungated and gated at packet
    8192) and the sweep gate against their plain versions on the first
    ``n`` of the 1.2k scene's rays, octmorton-sorted (the 12k scene and its
    rays are phase 2's own)."""
    scene, _, o, d = scale_scene(SCALES[0])
    o_dev = torch.from_numpy(o[:n]).to(dev)
    d_dev = torch.from_numpy(d[:n]).to(dev)
    rows = trace_rows(o_dev, d_dev, "octmorton")
    legs, err = compare_main_shapes({"scales_1200": (rows, scene)}, scene,
                                    {"wide_trace": 0.0, "sweep_gate": 0.0})
    return {"legs": legs, "max_abs_err": err, "gdepth": int(scene.gdepth),
            "groups": int(scene.gnodes.shape[1])}


def scales_phase(dev, card: str, issue: float, random_rps: float,
                 err: dict) -> dict:
    """Phase 17a, bench.py's scales leg: for 1,200 and 12,000 triangles
    (create_n_cubes(100), (1000)), 2,097,152 rays (create_rays, seeded after
    the scene's draws) through make_tracer(sort="octmorton", packet 8192,
    sweep on the 12k scene only): octmorton sort, trace, un-permute. Launch
    counts of the leg's main path, 4,096 sampled rays against brute force,
    the group walk (and the sweep gate) against its plain version on the
    leg's full sorted rows (bit for bit), end-to-end ms (CUDA events,
    median of 7) with the device breakdown, the walk's kernel ms beside its
    bound (work per ray from the plain walk on every 32nd row), and the
    rays/s against phase 5's 120k random leg (sweep off). Raises ``err``
    to the largest |kernel - plain|."""
    out = {}
    for nc in SCALES:
        scene, tris, o, d = scale_scene(nc)
        n_tris = int(tris[0].shape[0])
        leg = f"scales_{n_tris}"
        sweep = nc >= 1000
        tris_dev = tuple(torch.from_numpy(x).to(dev) for x in tris)
        o_dev, d_dev = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        tracer = make_tracer(scene, packet=8192, sweep=sweep, sort="octmorton")
        # the leg's main path: every count zero before, read after
        obs.reset()
        h = trace_sync(tracer, o_dev, d_dev)
        launches = {"wide_trace": n_launched("wide_trace"),
                    "sweep_gate": n_launched("sweep")}
        check(launches["wide_trace"] > 0, f"{leg}: the group walk never ran")
        check(launches["sweep_gate"] > 0 or not sweep,
              f"{leg}: the sweep gate never ran")
        t = h.t
        check(t.shape == (len(o),) and h.shape_id.shape == (len(o),),
              f"{leg}: shape")
        check(bool(((h.shape_id >= 0) == torch.isfinite(t)).all())
              and bool((t[torch.isfinite(t)] > 0).all()), f"{leg}: t values")
        bf = check_vs_brute(leg, o, d, t.cpu().numpy(), tris_dev, nc)
        rows = trace_rows(o_dev, d_dev, "octmorton")
        vs_plain, err = compare_main_shapes({leg: (rows, scene)},
                                            scene if sweep else None, err)
        ms = cuda_ms(lambda: tracer(o_dev, d_dev))
        breakdown = device_breakdown(lambda: tracer(o_dev, d_dev), ms)
        gn, grp = _dev(scene.gnodes, dev), _dev(scene.groups, dev)
        # the walk's FRAME build, which the leg launches on its host scene
        rec, alo = records(scene, dev), a_lo_of(scene, dev)
        walk_ms = cuda_ms(lambda: wide_mod.wide_trace(
            rec, grp, rows, scene.width, scene.gdepth, a_lo=alo))
        _, _, tests, fires = wide_mod.wide_trace_plain(
            gn, grp, rows[:, ::32].contiguous(), scene.width, counts=True,
            a_lo=alo)
        steps, fired = float(tests.float().mean()), float(fires.float().mean())
        nbytes = (wide_mod.N_ROWS * 4 * len(o) + rec.nbytes + grp.nbytes
                  + alo.nbytes + 8 * len(o))
        bound = walk_bound(len(o), scene.width, steps, fired, True, nbytes,
                           n_tris, frame=True)
        rps = len(o) / (ms * 1e-3)
        out[leg] = {
            "triangles": n_tris, "rays": len(o), "sweep": sweep,
            "width": int(scene.width), "gdepth": int(scene.gdepth),
            "groups": int(scene.gnodes.shape[1]), "launches": launches,
            "brute_force": bf, "kernels_vs_plain": vs_plain[leg],
            "ms": ms, "rays_per_s": rps, "ns_per_ray": ms * 1e6 / len(o),
            "vs_120k_random": rps / random_rps, "breakdown": breakdown,
            "walk": {"ms": walk_ms, "group_tests": steps, "leaf_fires": fired,
                     **bound,
                     "ops_ms_at_issue_rate": bound["ops"] / issue * 1e3}}
    return {"card": card, "legs": out, "random_120k_rays_per_s": random_rps}


def slab_leg(dev):
    """bench.py's ray_aabb_1000 inputs on ``dev``: the boxes of the first
    1,000 triangles of create_n_cubes(84) and 131,072 rays (create_rays,
    seeded after the scene's draws), the first half aimed at the box
    centres in turn, as ``Ray.create`` makes them."""
    a, b, c = tb.create_n_cubes(84)
    k = N_SLAB_BOXES
    mn, mx = tb.tri_aabbs(a[:k], b[:k], c[:k])
    o, d = tb.create_rays(N_SLAB_RAYS, seed=tb.seed_state_after(84))
    half = N_SLAB_RAYS // 2
    ctr = ((mn + mx) * 0.5)[np.arange(half) % k]
    d = d.copy()
    d[:half] = ctr - o[:half]
    d[:half] /= np.linalg.norm(d[:half], axis=1, keepdims=True)
    rays = Ray.create(o, d, device=dev)
    return (rays, torch.from_numpy(mn).to(dev).contiguous(),
            torch.from_numpy(mx).to(dev).contiguous())


def face_plane_rays(mn, mx, n: int = 64):
    """``n`` rays, ray i in the face plane x = box min x of box i mod B
    (no x component), and those boxes: the products of a ray and its box
    hold 0 * inf = NaN, a miss."""
    i = torch.arange(n, device=mn.device) % mn.shape[0]
    o = (mn[i] + mx[i]) * 0.5
    o[:, 0] = mn[i, 0]
    o[:, 2] -= 10.0
    d = torch.zeros_like(o)
    d[:, 2] = 1.0
    return Ray.create(o, d), mn[i], mx[i]


def ray_aabb_phase(dev, card: str, issue: float) -> tuple[dict, dict]:
    """Phase 17b, bench.py's ray_aabb_1000 leg: the hand-written slab count
    (csrc/slab_count.cu) on 131,072 rays x 1,000 boxes, its count equal to
    the plain version's exactly (also with face-plane rays), both timed in
    turns, ns a test and tests/s, the bound. Returns the phase's record and
    the kernel's entry."""
    rays, mn, mx = slab_leg(dev)
    o, inv = rays.origin.contiguous(), rays.inv_direction.contiguous()
    # the leg's main path: every count zero before, read after
    obs.reset()
    count = int(slab_mod.slab_count(o, inv, mn, mx))
    launches = n_launched("slab_count")
    check(launches > 0, "slab_count was never launched on its main path")
    plain = int(slab_mod.slab_count_plain(o, inv, mn, mx))
    check(count == plain, f"slab_count {count} != plain {plain}")
    face, own_mn, own_mx = face_plane_rays(mn, mx)
    fo, finv = face.origin.contiguous(), face.inv_direction.contiguous()
    both = (torch.cat([fo, o[:4096]]), torch.cat([finv, inv[:4096]]))
    face_k = int(slab_mod.slab_count(*both, mn, mx))
    face_p = int(slab_mod.slab_count_plain(*both, mn, mx))
    face_only = int(ray_intersects_aabb(face, own_mn, own_mx).sum())
    check(face_k == face_p, f"slab_count with face-plane rays {face_k} != "
          f"plain {face_p}")
    check(face_only == 0, f"{face_only} face-plane rays hit their own box")
    torch.cuda.synchronize()
    turns = in_turns({
        "kernel": lambda: slab_mod.slab_count(o, inv, mn, mx),
        "plain": lambda: slab_mod.slab_count_plain(o, inv, mn, mx)})
    ms, plain_ms = turns["kernel"]["ms"], turns["plain"]["ms"]
    tests = N_SLAB_RAYS * N_SLAB_BOXES
    ops = tests * slab_mod.SLAB_COUNT_OPS
    nbytes = 4 * 6 * (N_SLAB_RAYS + N_SLAB_BOXES) + 8
    bound_ms, by = roofline(ops, nbytes)
    rec = {"card": card, "rays": N_SLAB_RAYS, "boxes": N_SLAB_BOXES,
           "tests": tests, "hits": count, "hit_share": count / tests,
           "plain_hits": plain, "face_plane_own_box_hits": face_only,
           "launches": launches, "in_turns": turns,
           "ns_per_test": ms * 1e6 / tests, "tests_per_s": tests / (ms * 1e-3),
           "plain_ns_per_test": plain_ms * 1e6 / tests, "ops": ops,
           "bytes": nbytes, "bound_ms": bound_ms, "bound_by": by,
           "ops_ms_at_issue_rate": ops / issue * 1e3}
    entry = {"name": "slab_count", "route": "cuda",
             "source": "bvh_tpu_torch/csrc/slab_count.cu",
             "replaces": "bench.py:579", "launches": launches,
             "max_abs_err": float(abs(count - plain)), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
             "library_ms": plain_ms}
    return rec, entry


# ---- phase 18: the five examples' twins on the card -------------------------

# each twin's arguments: the original's default sizes
EXAMPLES = {
    "camera_tracer": (ex_camera, ["--size", "256"], "camera_depth.pgm"),
    "dynamic_scene": (ex_dynamic, ["--cubes", "1000", "--frames", "5",
                                   "--rays", "65536", "--churn", "0.02"], None),
    "nearest_query": (ex_nearest, ["--cubes", "1000", "--points", "65536"],
                      None),
    "obj_render": (ex_obj, ["--size", "512"], "obj_render.ppm"),
    "pathtrace": (ex_pathtrace, ["--size", "256", "--bounces", "2"],
                  "pathtrace.ppm"),
}


def launched_rows() -> dict:
    """The kernel builds launched since the last ``obs.reset()``, by the
    row of PERF.md's kernel table (every count that is not 0)."""
    counts = {
        "1 wide_trace": n_launched("wide_trace"),
        "1 any": n_launched("wide_trace.any"),
        "1 subtree": n_launched("wide_trace.subtree"),
        "1 frame": n_launched("wide_trace.frame"),
        "2 sweep_gate": n_launched("sweep"),
        "3 tight_trace": n_launched("tight_trace"),
        "3 any": n_launched("tight_trace.any"),
        "3 frame": n_launched("tight_trace.frame"),
        "3 skip": n_launched("tight_trace.skip"),
        "4 cluster_trace": n_launched("cluster_trace"),
        "5 nearest_entry_exit": n_launched("nearest_entry_exit"),
        "5 frame": n_launched("nearest_entry_exit.frame"),
        "6 nearest_wide": n_launched("nearest_wide"),
        "6 frame": n_launched("nearest_wide.frame"),
        "6 seed": n_launched("nearest_seed"),
        "slab_count": n_launched("slab_count")}
    return {k: v for k, v in counts.items() if v}


def run_example(name: str, out_dir: str) -> dict:
    """One twin's ``main`` at the original's default sizes, its counts zero
    before and read after; what it printed is kept, not echoed."""
    mod, argv, out = EXAMPLES[name]
    if out is not None:
        argv = argv + ["--out", os.path.join(out_dir, out)]
    obs.reset()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = mod.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    made = port_launches()
    check(made > 0, f"example {name} launched none of the port's kernels")
    if out is not None:
        check(os.path.getsize(os.path.join(out_dir, out)) > 0,
              f"example {name} wrote no image")
    return {"res": res, "seconds": seconds, "port_launches": made,
            "rows": launched_rows(), "printed": printed.getvalue().splitlines()}


def examples_phase(dev, card: str, tris_d) -> dict:
    """Phase 18: each twin of ``examples/`` (``bvh_tpu_torch.examples``)
    in this process at the original's default sizes, images to a temporary
    directory; each must launch the port's kernels (the rows it launched
    recorded) and pass its own checks and these: the camera's depth
    against brute force on 4,096 sampled pixels and its key plan equal to
    no plan; the dynamic loop's last frame against brute force over the
    moved triangles on 4,096 sampled rays and against a rebuild (agreement
    >= 0.99); the nearest query's brute-force and general-path checks; the
    OBJ render's hit share above one half, its loss and |grad| finite and
    |grad| above 0; the path tracer's colours finite and >= 0, its mean
    luminance in (0, 1)."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES:
            res[name] = run_example(name, tmp)
    cam = res["camera_tracer"].pop("res")
    outs = cam.pop("outputs")
    check(cam["plan_equal"], "camera: the key plan changed the free rays")
    cam["brute_force"] = check_vs_brute("example_camera", outs["o"],
                                        outs["d"], outs["t"], tris_d, 31)
    dyn = res["dynamic_scene"].pop("res")
    outs = dyn.pop("outputs")
    check(dyn["agree"] >= 0.99, f"dynamic: agreement {dyn['agree']} < 0.99")
    moved = tuple(torch.from_numpy(x).to(dev) for x in outs["tris"])
    dyn["brute_force"] = check_vs_brute("example_dynamic", outs["o"],
                                        outs["d"], outs["t"], moved, 32)
    near = res["nearest_query"].pop("res")
    check(near["brute_ok"] and near["general_ok"],
          "nearest: a brute-force or general-path check failed")
    obj = res["obj_render"].pop("res")
    check(obj["hit_fraction"] > 0.5, f"obj: hit share {obj['hit_fraction']}")
    check(obj["finite"] and obj["grad_norm"] > 0.0,
          f"obj: loss {obj['loss']}, |grad| {obj['grad_norm']}")
    pt = res["pathtrace"].pop("res")
    check(pt["finite"] and pt["non_negative"]
          and 0.0 < pt["mean_luminance"] < 1.0,
          f"pathtrace: colours or mean luminance {pt['mean_luminance']}")
    for name, summary in (("camera_tracer", cam), ("dynamic_scene", dyn),
                          ("nearest_query", near), ("obj_render", obj),
                          ("pathtrace", pt)):
        res[name]["summary"] = summary
    return {"card": card, "examples": res}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = build_all()
    emit("device", name=name, nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=builds)

    # ---- phase 2: kernels vs plain ------------------------------------
    t0 = time.perf_counter()
    p2 = phase_kernels(dev)
    emit("kernels_vs_plain", seconds=time.perf_counter() - t0, **p2)
    t0 = time.perf_counter()
    p2n = phase_nearest_kernels(dev)
    emit("nearest_kernels_vs_plain", seconds=time.perf_counter() - t0, **p2n)
    t0 = time.perf_counter()
    p2t = phase_trace_modes(dev)
    emit("trace_modes_vs_plain", seconds=time.perf_counter() - t0, **p2t)
    t0 = time.perf_counter()
    p2l = phase_legacy_kernels(dev)
    emit("legacy_kernel_vs_plain", seconds=time.perf_counter() - t0, **p2l)
    t0 = time.perf_counter()
    p2f = phase_frame_kernels(dev)
    emit("frame_kernels_vs_plain", seconds=time.perf_counter() - t0,
         legs=p2f)
    t0 = time.perf_counter()
    p2s = phase_scales_kernels(dev)
    emit("scales_kernels_vs_plain", seconds=time.perf_counter() - t0, **p2s)

    # ---- phase 3: main path at full width ------------------------------
    a, b, c = tb.create_n_cubes(10000)
    t0 = time.perf_counter()
    scene = build_tight_scene(a, b, c)
    build_s = time.perf_counter() - t0
    check(scene.gnodes is not None and scene.width == 16, "120k scene layout")
    tris_dev = tuple(torch.from_numpy(x).to(dev) for x in (a, b, c))
    o, d, ao, ad = main_rays(a)
    n_rand, n_aim = len(o), len(ao)
    o_dev, d_dev = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    ao_dev, ad_dev = torch.from_numpy(ao).to(dev), torch.from_numpy(ad).to(dev)
    tr_rand = make_tracer(scene, packet=8192, sweep=False, sort="octmorton")
    tr_sweep = make_tracer(scene, packet=8192, sweep=True, sort="octmorton")
    tr_aim = make_tracer(scene, packet=8192, sort="morton", tris=(a, b, c))
    tr_aim_off = make_tracer(scene, packet=8192, sweep=False, sort="morton",
                             tris=(a, b, c))
    ad_, bd_, cd_ = tb.create_dense_mesh()
    scene_d = build_tight_scene(ad_, bd_, cd_, leaf_size=128)
    check(scene_d.gnodes is not None and scene_d.width == 128, "dense layout")
    tris_d = tuple(torch.from_numpy(x).to(dev) for x in (ad_, bd_, cd_))
    side = CAMERA_SIDE
    oc, dc = dense_camera()
    oc_dev, dc_dev = torch.from_numpy(oc).to(dev), torch.from_numpy(dc).to(dev)
    tr_cam = make_tracer(scene_d, packet=4096, sweep=False, sort=None)

    # the main path: every count is zero before and read after
    obs.reset()
    h_rand = trace_sync(tr_rand, o_dev, d_dev)
    h_sweep = trace_sync(tr_sweep, o_dev, d_dev)
    h_aim = trace_sync(tr_aim, ao_dev, ad_dev)
    h_cam = trace_sync(tr_cam, oc_dev, dc_dev)
    launches = {"wide_trace": n_launched("wide_trace"),
                "sweep_gate": n_launched("sweep"),
                "trace_epilogue": n_launched("trace_epilogue"),
                "ray_key": n_launched("ray_key"),
                "ray_rows": n_launched("ray_rows")}
    emit("main_path_launches", **launches,
         wide_trace_frame=n_launched("wide_trace.frame"))
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the main path")
    check(launches["trace_epilogue"] == 4,
          "the main path's four calls did not launch one epilogue each")
    check(launches["ray_key"] == 3 == n_launched("ray_bounds")
          == n_launched("ray_unsort") and launches["ray_rows"] == 4,
          "the main path's calls did not launch the key and the un-sort a "
          "sorted call and the rows a call")
    # host builds carry a_lo: every group walk of the path is a FRAME launch
    check(n_launched("wide_trace.frame") == launches["wide_trace"],
          "a group walk of the main path did not take the FRAME build")

    t_rand = h_rand.t.cpu().numpy()
    sid_rand = h_rand.shape_id.cpu().numpy()
    same = (np.array_equal(t_rand.view(np.int32),
                           h_sweep.t.cpu().numpy().view(np.int32))
            and np.array_equal(sid_rand, h_sweep.shape_id.cpu().numpy()))
    check(same, "sweep=True changed the random leg's results")
    for name_, h, n_ in (("random", h_rand, n_rand), ("aimed", h_aim, n_aim),
                         ("camera", h_cam, side * side)):
        t = h.t
        check(t.shape == (n_,) and h.shape_id.shape == (n_,), f"{name_} shape")
        check(bool((torch.isfinite(t) | torch.isinf(t)).all())
              and bool((t[torch.isfinite(t)] > 0).all()), f"{name_} t values")
        check(bool(((h.shape_id >= 0) == torch.isfinite(t)).all()),
              f"{name_}: shape ids disagree with hits")
    hit_aim = float(torch.isfinite(h_aim.t).float().mean())
    check(hit_aim >= 0.999, f"aimed hit fraction {hit_aim} < 0.999")
    bf_rand = check_vs_brute("random", o, d, t_rand, tris_dev, 1)
    bf_aim = check_vs_brute("aimed", ao, ad, h_aim.t.cpu().numpy(), tris_dev, 2)
    emit("main_path", triangles=int(a.shape[0]), build_s=build_s,
         clusters=int(scene.num_clusters), width=int(scene.width),
         gdepth=int(scene.gdepth), rays_random=n_rand, rays_aimed=n_aim,
         hit_fraction_random=float(np.isfinite(t_rand).mean()),
         hit_fraction_aimed=hit_aim, sweep_identical=same,
         brute_force=[bf_rand, bf_aim])

    # ---- phase 4: W=128 dense mesh camera -------------------------------
    hit_cam = float(torch.isfinite(h_cam.t).float().mean())
    bf_cam = check_vs_brute("camera", oc, dc, h_cam.t.cpu().numpy(), tris_d, 3)
    # the package's diff.camera_rays against this script's numpy twin, as
    # the tracer takes the twin's rays (normalized on the card), row-major
    pkg = package_camera_rays(*CAMERA, side, side, device=dev)
    twin = Ray.create(*(torch.from_numpy(x).to(dev)
                        for x in camera_rays(*CAMERA, side, side)))
    cam_cmp = {"origins_equal": torch.equal(pkg.origin, twin.origin),
               "direction_values_differ": int(
                   (pkg.direction.view(torch.int32)
                    != twin.direction.view(torch.int32)).sum()),
               "direction_max_abs_diff": float(
                   (pkg.direction - twin.direction).abs().max())}
    emit("dense_camera", triangles=int(ad_.shape[0]),
         clusters=int(scene_d.num_clusters), width=int(scene_d.width),
         rays=side * side, hit_fraction=hit_cam, brute_force=bf_cam,
         package_camera_rays_vs_twin=cam_cmp)

    # ---- phase 5: timings ------------------------------------------------
    legs = {
        "random_sweep_off": (tr_rand, o_dev, d_dev),
        "random_sweep_on": (tr_sweep, o_dev, d_dev),
        "aimed": (tr_aim, ao_dev, ad_dev),
        "aimed_sweep_off": (tr_aim_off, ao_dev, ad_dev),
        "camera_w128": (tr_cam, oc_dev, dc_dev),
    }
    e2e = {}
    for leg, (tr, od, dd) in legs.items():
        ms = cuda_ms(lambda: tr(od, dd))
        e2e[leg] = {"ms": ms, "rays_per_s": od.shape[0] / (ms * 1e-3)}
    emit("breakdown", card=card, legs={
        leg: device_breakdown(lambda tr=tr, od=od, dd=dd: tr(od, dd),
                              e2e[leg]["ms"])
        for leg, (tr, od, dd) in legs.items()})
    # each kernel at the main path's shapes (the legs' sorted rows), held
    # against its plain version on the same rows, and both timed there
    gn, grp = _dev(scene.gnodes, dev), _dev(scene.groups, dev)
    sn = _dev(scene.smem_nodes, dev)
    kernel_rows = {
        "random": (trace_rows(o_dev, d_dev, "octmorton"), scene),
        "aimed": (trace_rows(ao_dev, ad_dev, "morton"), scene),
        "camera_w128": (trace_rows(oc_dev, dc_dev, None), scene_d)}
    t0 = time.perf_counter()
    main_vs_plain, err = compare_main_shapes(kernel_rows, scene,
                                             dict(p2["max_abs_err"]))
    emit("kernels_vs_plain_main_path", seconds=time.perf_counter() - t0,
         legs=main_vs_plain, max_abs_err=err)
    # the group walk's FRAME build, which the path launches on host scenes
    kernel_ms, plain_ms = {}, {}
    for leg, (rows, sc) in kernel_rows.items():
        g_, r_ = _dev(sc.gnodes, dev), _dev(sc.groups, dev)
        rec, alo = records(sc, dev), a_lo_of(sc, dev)
        kernel_ms[f"wide_trace/{leg}"] = cuda_ms(
            lambda: wide_mod.wide_trace(rec, r_, rows, sc.width, sc.gdepth,
                                        a_lo=alo))
        plain_ms[f"wide_trace/{leg}"] = cuda_ms(
            lambda: wide_plain_chunked(g_, r_, rows, sc.width, a_lo=alo),
            reps=5, warmup=0)
    rows_r = kernel_rows["random"][0]
    sr = node_recs(scene.smem_nodes, dev)
    kernel_ms["sweep_gate/random"] = cuda_ms(
        lambda: sweep_mod.sweep_gate(sr, rows_r, 8192))
    plain_ms["sweep_gate/random"] = cuda_ms(
        lambda: sweep_mod.sweep_gate_plain(sn, rows_r, 8192), reps=5, warmup=0)

    # bounds: work per ray counted by the plain versions on a sample of the
    # main path's rays (each ray's walk is independent of the others)
    n = rows_r.shape[1]
    sample = rows_r[:, ::32].contiguous()
    _, _, tests, fires = wide_mod.wide_trace_plain(
        gn, grp, sample, scene.width, counts=True, a_lo=a_lo_of(scene, dev))
    tests_pr, fires_pr = float(tests.float().mean()), float(fires.float().mean())
    W = scene.width
    wide_b = walk_bound(n, W, tests_pr, fires_pr, True,
                        wide_mod.N_ROWS * 4 * n + records(scene, dev).nbytes
                        + scene.groups.nbytes + scene.a_lo.nbytes + 8 * n,
                        a.shape[0], frame=True)
    wide_ops, wide_bytes = wide_b["ops"], wide_b["bytes"]
    # the sweep's least work, from every ray's walk
    sweep_b = sweep_bound(sn, rows_r, 8192)

    # the epilogue kernel on the aimed leg's walk (recompute and un-sort)
    # and the camera leg's (neither), as make_tracer hands them on
    t0 = time.perf_counter()
    epi = {"aimed": epilogue_leg(scene, ao_dev, ad_dev, "morton", 8192, True,
                                 torch.cat(tris_dev, dim=1)),
           "camera_w128": epilogue_leg(scene_d, oc_dev, dc_dev, None, 4096,
                                       False)}
    emit("epilogue_vs_plain_main_path", card=card,
         seconds=time.perf_counter() - t0, legs=epi)
    # the order kernels on the aimed and random legs' rays, as make_tracer
    # takes them
    t0 = time.perf_counter()
    order = {"aimed": order_leg(ao_dev, ad_dev, "morton"),
             "random": order_leg(o_dev, d_dev, "octmorton")}
    emit("order_vs_plain_main_path", card=card,
         seconds=time.perf_counter() - t0, legs=order)

    wb, wby = wide_b["bound_ms"], wide_b["bound_by"]
    # the same operations at the float32 issue rate without FMA pairing
    # (the kernels are built with -fmad=false): 128 lanes per SM per clock
    issue = fp32_issue_rate()
    emit("timings", card=card, end_to_end=e2e, kernel_ms=kernel_ms,
         plain_ms=plain_ms, plain_ms_phase2=p2["plain_ms"],
         work_per_ray={"group_tests": tests_pr, "leaf_fires": fires_pr},
         fp32_issue_per_s=issue,
         wide_trace={"ops": wide_ops, "bytes": wide_bytes, "bound_ms": wb,
                     "ops_ms_at_issue_rate": wide_ops / issue * 1e3},
         sweep_gate={**sweep_b,
                     "ops_ms_at_issue_rate": sweep_b["ops"] / issue * 1e3})
    kernels = [
        {"name": "wide_trace", "route": "cuda",
         "source": "bvh_tpu_torch/csrc/wide_trace.cu",
         "replaces": "bvh_tpu/ops/trace.py:1178",
         "launches": launches["wide_trace"],
         "max_abs_err": err["wide_trace"],
         "ms": kernel_ms["wide_trace/random"],
         "plain_ms": plain_ms["wide_trace/random"],
         "bound_ms": wb, "bound_by": wby, "library_ms": None},
        {"name": "sweep_gate", "route": "cuda",
         "source": "bvh_tpu_torch/csrc/sweep.cu",
         "replaces": "bvh_tpu/ops/trace.py:851",
         "launches": launches["sweep_gate"],
         "max_abs_err": err["sweep_gate"],
         "ms": kernel_ms["sweep_gate/random"],
         "plain_ms": plain_ms["sweep_gate/random"],
         "bound_ms": sweep_b["bound_ms"], "bound_by": sweep_b["bound_by"],
         "library_ms": None},
        {"name": "trace_epilogue", "route": "cuda",
         "source": "bvh_tpu_torch/csrc/epilogue.cu",
         "replaces": "bvh_tpu/ops/trace.py:1885 (an XLA fusion)",
         "launches": launches["trace_epilogue"],
         "max_abs_err": 0.0,  # bit for bit (epilogue_leg's check)
         "ms": epi["aimed"]["ms"], "plain_ms": epi["aimed"]["plain_ms"],
         "bound_ms": epi["aimed"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        *({"name": f"ray_{part}", "route": "cuda",
           "source": "bvh_tpu_torch/csrc/order.cu",
           "replaces": "bvh_tpu/ops/trace.py sort_rays_device, _ray_rows "
                       "(XLA fusions)",
           "launches": launches[f"ray_{part}"],
           "max_abs_err": 0.0,  # bit for bit (order_leg's check)
           "ms": order["aimed"][part]["ms"],
           "plain_ms": order["aimed"][part]["plain_ms"],
           "bound_ms": order["aimed"][part]["bound_ms"], "bound_by": "bytes",
           "library_ms": None} for part in ("key", "rows")),
    ]

    # ---- phases 6 and 7: the nearest main path and its timings ----------
    kernels += nearest_phases(dev, card, scene, (a, b, c), scene_d,
                              (ad_, bd_, cd_), issue,
                              dict(p2n["max_abs_err"]))

    # ---- phases 8 and 9: the path tracer and the entry/exit legs --------
    err3 = dict(p2t["max_abs_err"])
    kernels.append(pathtrace_phase(dev, card, scene_d, (ad_, bd_, cd_),
                                   oc_dev, dc_dev, issue, err3))
    kernels += entry_exit_phase(dev, card, scene, (a, b, c), ao, ad, ao_dev,
                                ad_dev, o_dev, d_dev, h_aim, issue, err3)

    # ---- phases 10 and 11: the legacy path and chained scenes -----------
    kernels.append(legacy_phase(dev, card, (a, b, c), o, d, ao, ad, h_aim,
                                issue, dict(p2l["max_abs_err"])))
    chain_err, chain, chain_tris = chained_phase(dev, card, scene, (a, b, c))

    # ---- phase 12: the planned aimed leg and diff_fwd_bwd, last, so that
    # its profile of a backward pass follows every other leg's -----------
    kernels.append(planned_phase(dev, card, scene, (a, b, c), ao, ad, ao_dev,
                                 ad_dev, h_aim, issue, dict(p2["max_abs_err"])))

    # ---- phase 13: dynamic scenes and the visit counters, last ----------
    t0 = time.perf_counter()
    entries, keep = dynamic_phase(dev, card, scene, (a, b, c), o, d, ao, ad,
                                  issue)
    kernels += entries
    emit("dynamic_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    host_frame_phase(dev, card, scene, scene_d, (a, b, c), o, d, ao, ad,
                     chain, chain_tris, issue)
    emit("host_frame_phase", seconds=time.perf_counter() - t0)

    # ---- phase 14: the general pure-tensor path at full size ------------
    t0 = time.perf_counter()
    pr_dev = torch.from_numpy(tb.create_rays(
        N_POINTS, seed=tb.seed_state_after(10007))[0]).to(dev)  # phase 7's
    general_phase(dev, card, scene, (a, b, c), ao, ad, h_aim, pr_dev)
    emit("general_phase", seconds=time.perf_counter() - t0)

    # ---- phase 15: io ------------------------------------------------------
    t0 = time.perf_counter()
    io_res = io_phase(dev, card, scene, (a, b, c), ao_dev, ad_dev, h_aim, keep)
    io_s = time.perf_counter() - t0
    emit("io", card=card, seconds=io_s, **io_res)
    check(io_s < 60.0, f"phase 15 took {io_s} s, over its 60 s")

    # ---- phase 16: parallel -------------------------------------------------
    t0 = time.perf_counter()
    par = parallel_phase(dev, card, scene, (a, b, c), o_dev, d_dev, ao_dev,
                         ad_dev, h_aim)
    par_s = time.perf_counter() - t0
    emit("parallel", seconds=par_s, **par)
    check(par_s < 60.0, f"phase 16 took {par_s} s, over its 60 s")

    # ---- phase 17: bench.py's scales and ray_aabb_1000 legs ---------------
    t0 = time.perf_counter()
    err17 = dict(p2s["max_abs_err"])
    sc = scales_phase(dev, card, issue, e2e["random_sweep_off"]["rays_per_s"],
                      err17)
    emit("scales", **sc)
    slab_rec, slab_entry = ray_aabb_phase(dev, card, issue)
    emit("ray_aabb_1000", **slab_rec)
    kernels.append(slab_entry)
    p17_s = time.perf_counter() - t0
    emit("phase_17", seconds=p17_s, max_abs_err=err17)
    check(p17_s < 60.0, f"phase 17 took {p17_s} s, over its 60 s")

    # ---- phase 18: the five examples' twins -------------------------------
    t0 = time.perf_counter()
    ex = examples_phase(dev, card, tris_d)
    p18_s = time.perf_counter() - t0
    emit("examples", seconds=p18_s, **ex)
    check(p18_s < 90.0, f"phase 18 took {p18_s} s, over its 90 s")
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], err17.get(k["name"], 0.0))
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], chain_err.get(k["name"], 0.0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
