"""The scene maker ``spd_tetra``: the ``tetra`` database of E. Haines's
Standard Procedural Databases (IEEE CG&A, Nov. 1987; ``tetra.c`` in
github.com/erich666/StandardProceduralDatabases), a recursive tetrahedral
pyramid. A configuration names its maker by this file's name.

The pyramid starts as the regular tetrahedron with corners ``(1, 1, 1)``,
``(-1, -1, 1)``, ``(-1, 1, -1)`` and ``(1, -1, -1)`` (the unit cube's
alternate corners, centred on the origin). Each level replaces every
tetrahedron by four of half its size, one at each of its corners, so size
factor ``sf`` gives 4**sf tetrahedra of 4 triangles each: 4**(sf + 1)
triangles, 262,144 at ``sf = 8``. Every face is wound outwards, so the
tracer's backface culling sees the outside. Coordinates are multiples of
2**-sf, exact in float32, and the same on every call. Triangles are SoA:
``a, b, c`` each [N, 3] float32 numpy, tetrahedron by tetrahedron in the
order of the recursion (corner 0 first).

``VIEW`` and ``BACKGROUND`` are the database's camera and background
colour as the configuration states them; ``LIGHT`` and ``LIGHT_POWER``,
the point light, are set here (see the configuration's ``assumed``).
"""

from __future__ import annotations

import numpy as np

# the corners of a tetrahedron, as offsets from its centre in units of its
# size, and its four faces, wound so that (b - a) x (c - a) points outwards
CORNERS = np.array([[1, 1, 1], [-1, -1, 1], [-1, 1, -1], [1, -1, -1]],
                   np.float64)
FACES = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])

# the database's view: eye, look-at point, up vector, vertical field of
# view in degrees (the database renders it at 512 x 512)
VIEW = {"from": (1.022846, -3.177154, -2.174512),
        "at": (-0.004103, -0.004103, 0.216539),
        "up": (-0.816497, -0.816497, 0.816497),
        "angle": 45.0}
BACKGROUND = (0.078, 0.361, 0.753)  # the database's sky blue
# the point light, set here: outside the pyramid, 4 from its centre, above
# it (along the view's up, towards the apex) and towards the eye, so that
# the faces the camera sees are lit from above and the lattice shadows
# them; at power 16 a face square to it at the centre gets its colour
LIGHT = (-1.6, -3.5, 1.1)
LIGHT_POWER = 16.0


def tetra_centres(sf: int) -> tuple:
    """The centres [4**sf, 3] and the size of the pyramid's tetrahedra at
    size factor ``sf``, in the recursion's order."""
    centres, size = np.zeros((1, 3)), 1.0
    for _ in range(sf):
        size /= 2.0
        centres = (centres[:, None] + size * CORNERS[None]).reshape(-1, 3)
    return centres, size


def make(sf: int):
    """The pyramid at size factor ``sf``: 4**(sf + 1) triangles."""
    if sf < 0:
        raise ValueError(f"size factor {sf} < 0")
    centres, size = tetra_centres(sf)
    verts = centres[:, None] + size * CORNERS[None]  # [T, 4, 3]
    tris = verts[:, FACES].reshape(-1, 3, 3).astype(np.float32)
    return tris[:, 0].copy(), tris[:, 1].copy(), tris[:, 2].copy()


SMALL = {"sf": 3}  # the CPU tests' args: 256 triangles
