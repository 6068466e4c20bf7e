"""Invariant checkers for a ``TightScene``'s tables.

Counterpart of ``bvh_tpu/ops/validate_scene.py`` (numpy): the structure
the trace kernels assume (the entry/exit node table, the 128-lane group
rows, the wide group-walk table), checked after any build, refit or
update; a malformed table traces garbage without an error. The scene's
tables may be numpy arrays or tensors on any device (read on the host):
host and device builds, the parts of chained scenes, refit and update
scenes. The messages are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def check_tight_scene(scene, a=None, b=None, c=None,
                      atol: float = 0.1) -> list[str]:
    """Structural + geometric invariants of a TightScene; returns errors.

    With ``a, b, c`` (the build's vertex arrays) also checks that every
    cluster's triangles lie inside its leaf box and that the packed group
    rows reconstruct the vertices (within f32 frame-shift rounding,
    ``atol``). Without them, only table-structure checks run.
    """
    errs: list[str] = []
    sn = _host(scene.smem_nodes)
    nn = int(scene.num_nodes)
    W = int(getattr(scene, "width", 16))
    tri_map = _host(scene.tri_map)

    if sn.shape[0] != 8:
        return [f"node table must have 8 rows, got {sn.shape[0]}"]
    if sn.shape[1] < nn:
        return [f"node table narrower ({sn.shape[1]}) than num_nodes ({nn})"]

    entry = sn[6, :nn]
    exit_ = sn[7, :nn].astype(np.int64)
    is_leaf = entry < 0

    # --- DFS entry/exit structure ---
    t = np.arange(nn)
    bad = (exit_ <= t) | (exit_ > nn)
    if bad.any():
        errs.append(f"{bad.sum()} exits outside (t, num_nodes]")
    internal = ~is_leaf
    if internal.any() and not (entry[internal] == t[internal] + 1).all():
        errs.append("internal entry != t+1 (preorder first-child invariant)")
    if is_leaf.any() and not (exit_[is_leaf] == t[is_leaf] + 1).all():
        errs.append("leaf exit != t+1")
    # interval nesting: a child interval must close before its parent's
    stack: list[int] = []
    for i in range(nn):
        while stack and exit_[stack[-1]] <= i:
            stack.pop()
        if stack and exit_[i] > exit_[stack[-1]]:
            errs.append(f"interval of node {i} escapes its ancestor")
            break
        stack.append(i)

    # --- leaf payloads cover every cluster exactly once ---
    C = int(scene.num_clusters)
    leaf_cluster = (-entry[is_leaf] - 1.0).astype(np.int64)
    if (leaf_cluster < 0).any() or (leaf_cluster >= C).any():
        errs.append("leaf cluster payload out of range")
    else:
        counts = np.bincount(leaf_cluster, minlength=C)
        # clusters holding triangles must appear exactly once in the leaf set
        occ_cl = np.unique(np.nonzero(tri_map >= 0)[0] // W)
        occ_cl = occ_cl[occ_cl < C]
        multi = counts[occ_cl] != 1
        if multi.any():
            errs.append(f"{multi.sum()} occupied clusters not exactly once "
                        "in the leaf set")

    if errs:
        return errs  # geometric checks below assume a well-formed walk

    # --- box consistency: every descendant box inside its ancestor ---
    bmin = sn[0:3, :nn].T
    bmax = sn[3:6, :nn].T
    finite = np.isfinite(bmin).all(axis=1) & np.isfinite(bmax).all(axis=1)
    for i in np.nonzero(internal)[0]:
        j = i + 1
        e = exit_[i]
        while j < e:
            if finite[j] and finite[i]:
                if (bmin[j] < bmin[i] - 0).any() or (bmax[j] > bmax[i] + 0).any():
                    errs.append(f"child {j} box escapes node {i}")
                    break
            j = exit_[j]
        else:
            continue
        break

    # --- tri_map: permutation of 0..n-1 plus -1 pads ---
    valid_ids = tri_map[tri_map >= 0]
    if valid_ids.size:
        uniq, cnt = np.unique(valid_ids, return_counts=True)
        if (cnt > 1).any():
            errs.append(f"{(cnt > 1).sum()} triangle ids packed twice")

    if a is not None:
        a, b, c = (_host(x).astype(np.float32) for x in (a, b, c))
        groups = _host(scene.groups)
        rows = groups.transpose(0, 2, 1).reshape(-1, 16)  # [lanes, 16]
        lanes = np.nonzero(tri_map >= 0)[0]
        tid = tri_map[lanes]
        cl = lanes // W
        # cluster frame origin = f32 box center of the cluster's leaf column
        col_of_cluster = np.full(C, -1, np.int64)
        col_of_cluster[leaf_cluster] = np.nonzero(is_leaf)[0]
        col = col_of_cluster[cl]
        ok_col = col >= 0
        cc = ((bmin[col] + bmax[col]) * 0.5)[ok_col]
        ln = lanes[ok_col]
        ti = tid[ok_col]
        ra = rows[ln, 0:3] + cc
        rb = rows[ln, 3:6] + ra
        rc = rows[ln, 6:9] + ra
        scale = np.maximum(np.abs(a[ti]).max(initial=1.0), 1.0)
        tol = atol * max(scale / 1e5, 1.0)
        for got, want, name in ((ra, a[ti], "a"), (rb, b[ti], "b"),
                                (rc, c[ti], "c")):
            d = np.abs(got - want).max() if got.size else 0.0
            if d > tol:
                errs.append(f"group rows reconstruct {name} off by {d:.3g} "
                            f"(tol {tol:.3g})")
        # leaf boxes contain their triangles
        mn = np.minimum(np.minimum(a[ti], b[ti]), c[ti])
        mx = np.maximum(np.maximum(a[ti], b[ti]), c[ti])
        if ((mn < bmin[col[ok_col]] - tol).any()
                or (mx > bmax[col[ok_col]] + tol).any()):
            errs.append("triangle outside its cluster leaf box")

    # --- wide tables (when present) ---
    gn = getattr(scene, "gnodes", None)
    if gn is not None:
        gn = _host(gn)
        if gn.shape[0] % 7 != 1:
            errs.append("wide table must have 7K+1 rows")
        gslot = _host(scene.gslot)
        K = (gn.shape[0] - 1) // 7
        Gn = gn.shape[1]
        if gslot.shape[0] < C:
            errs.append("gslot shorter than cluster count")
        elif ((gslot[:C] < 0) | (gslot[:C] >= K * Gn)).any():
            errs.append("gslot out of range")
        else:
            pay = gn[6:7 * K:7, :]  # [K, Gn]
            lmask = gn[7 * K].astype(np.int64)
            leaf_sl = ((lmask[None, :] >> np.arange(K)[:, None]) & 1) > 0
            inter_sl = pay >= 0
            gmin = np.stack([gn[7 * k + 0:7 * k + 3] for k in range(K)])
            gmax = np.stack([gn[7 * k + 3:7 * k + 6] for k in range(K)])
            # leaf-slot boxes must EQUAL their cluster's leaf box — the
            # sharp staleness check (a refit that forgot the wide table
            # fails here the moment geometry moves)
            col_of_cl = np.full(C, -1, np.int64)
            col_of_cl[leaf_cluster] = np.nonzero(is_leaf)[0]
            ks, gs = np.nonzero(leaf_sl)
            cl_ids = (-pay[ks, gs]).astype(np.int64) - 1
            if (cl_ids < 0).any() or (cl_ids >= C).any():
                errs.append("wide leaf payload out of cluster range")
            else:
                cols = col_of_cl[cl_ids]
                okc = cols >= 0
                want_mn = sn[0:3, :nn][:, cols[okc]]
                want_mx = sn[3:6, :nn][:, cols[okc]]
                got_mn = gmin[ks[okc], :, gs[okc]].T
                got_mx = gmax[ks[okc], :, gs[okc]].T

                def neq(x, y):  # NaN==NaN here (both mean "unfireable")
                    return (x != y) & ~(np.isnan(x) & np.isnan(y))

                if neq(got_mn, want_mn).any() or neq(got_mx, want_mx).any():
                    bad = (neq(got_mn, want_mn).any(axis=0)
                           | neq(got_mx, want_mx).any(axis=0)).sum()
                    errs.append(f"{bad} wide leaf-slot boxes != their "
                                "cluster leaf box (stale wide table?)")
            # interior slots must CONTAIN every occupied slot of the child
            # group (the traversal's pruning invariant)
            ki, gi = np.nonzero(inter_sl & ~leaf_sl)
            cg = pay[ki, gi].astype(np.int64)
            if (cg >= Gn).any():
                errs.append("wide interior payload out of group range")
            else:
                # exclude empty slots AND NaN (unfireable, vacated) child
                # boxes from the union — np.min would propagate the NaN and
                # make the containment check vacuously pass for any group
                # with one empty-cluster child
                occ_child = ((leaf_sl | inter_sl)[:, cg][:, None, :]
                             & ~np.isnan(gmin[:, :, cg]))  # [K, 3, n_int]
                cmn = np.where(occ_child, gmin[:, :, cg], np.inf)
                cmx = np.where(occ_child, gmax[:, :, cg], -np.inf)
                u_mn = cmn.min(axis=0)  # [3, n_int]
                u_mx = cmx.max(axis=0)
                p_mn = gmin[ki, :, gi].T
                p_mx = gmax[ki, :, gi].T
                if (u_mn < p_mn).any() or (u_mx > p_mx).any():
                    bad = ((u_mn < p_mn).any(axis=0)
                           | (u_mx > p_mx).any(axis=0)).sum()
                    errs.append(f"{bad} wide interior slots do not contain "
                                "their child group")

    return errs


def assert_tight_scene(scene, a=None, b=None, c=None) -> None:
    errs = check_tight_scene(scene, a, b, c)
    if errs:
        raise AssertionError("TightScene invalid: " + "; ".join(errs[:8]))
